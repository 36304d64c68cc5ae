"""Device milliseconds of the gradient exchange in one optimizer step of
rank 0: the NCCL all-reduce kernels of the profiled step (the trainer's
one flat bucket under its ``train.all_reduce`` span), whose time holds
the wait for the slowest rank. The span's own host time is the
collective's enqueue alone under NCCL (the run's log gives it), so the
device's kernels are read."""

LAYER = "parallel (parallel/dist.py, NCCL)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "train_frames_per_s"
FRAGMENTS = ("allreduce",)


def read(r):
    if r.trace is None or not r.stretch_calls:
        return None
    ops = r.trace.matching(FRAGMENTS)
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / 1e3 / r.stretch_calls
