"""Device milliseconds RAFT takes a (query, ref) pair in the motion-
compensated edit: the device intervals of the program's ``flow.raft``
spans (each RAFT call of ``RaftFlow.batch``, 16 pairs) over the traced
window's edits, over the pairs the program counted there (``raft.pairs``,
96 an edit)."""

LAYER = "flow (models/raft.py, utils/flow.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "edit_fps"


def read(r):
    pairs = r.counts.get("raft_pairs")
    if not pairs or "raft" not in r.spans:
        return None
    return 1e3 * r.spans["raft"] / pairs
