"""Device milliseconds a RAFT call (16 pairs) spends in its correlation
lookups: the device intervals of the program's ``raft.lookup`` spans (one
an update, 12 a call) over the traced window's edits, over its
``flow.raft`` calls."""

LAYER = "flow (models/raft.py, utils/flow.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "edit_fps"


def read(r):
    calls = r.counts.get("raft_calls")
    if not calls or "raft_lookup" not in r.spans:
        return None
    return 1e3 * r.spans["raft_lookup"] / calls
