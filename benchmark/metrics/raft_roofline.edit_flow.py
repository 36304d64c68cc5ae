"""RAFT's share of its roofline in the motion-compensated edit: the least
time of the window's pairs (``raft.pairs``) at a pair's work
(``work/raft.py``: its operations at the dense TF32 peak, 494.7 TFLOP/s,
or its float32 bytes at 3.35 TB/s, the larger) over the device time of
the program's ``flow.raft`` spans, in %."""

from harness import PEAK_BYTES
from work.raft import PEAK_TF32_FLOPS

LAYER = "flow (models/raft.py, utils/flow.py)"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "edit_fps"


def read(r):
    pairs, work = r.counts.get("raft_pairs"), r.work.get("raft")
    if not pairs or not work or not r.spans.get("raft"):
        return None
    flops, nbytes = work[0]
    return 100.0 * pairs * max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) / r.spans["raft"]
