"""Device-busy milliseconds a microbatch: the union of the device
operations' intervals over one profiled optimizer step (its forward,
remat and backward passes, the optimizer step), over its microbatches."""

LAYER = "model (models/unet3d.py, models/modelscope_t2v.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "train_frames_per_s"


def read(r):
    busy = r.busy_ms_per_call()
    if busy is None or not r.counts.get("steps"):
        return None
    return busy * r.counts["steps"] / r.counts["microbatches"]
