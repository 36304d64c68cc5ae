"""Host milliseconds ``PrefetchLoader``'s thread takes to make a batch
(``loader.produce`` around ``batch_fn()``: decode, augmentation, stacking
and pinning of a step's batch), the median over the run's batches (those
the profiler ran over left out)."""

from program_spans import host_ms, per_record, snapshot

LAYER = "host data (data/native_loader.py, data/datasets.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_frames_per_s"


def value(snap):
    return per_record(snap, "loader.produce", host_ms)


def read(r):
    return value(snapshot())
