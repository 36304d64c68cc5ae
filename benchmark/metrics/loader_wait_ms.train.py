"""Milliseconds a microbatch that the training loop waits on the port's
``PrefetchLoader`` for its batch (the driver's span around ``next``)."""

LAYER = "host data (data/native_loader.py, data/datasets.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "train_frames_per_s"


def read(r):
    n = r.counts.get("microbatches")
    return 1e3 * r.spans["wait"] / n if n and "wait" in r.spans else None
