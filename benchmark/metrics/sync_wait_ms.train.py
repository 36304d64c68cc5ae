"""Host milliseconds a step waits for its loss (``train.loss_sync``, the
``float(loss)`` at the step's end): the device's backlog when the host has
dispatched the whole step; the median over the run's steps (steps the
profiler ran over left out)."""

from program_spans import per_unit_ms, snapshot

LAYER = "trainer (training/trainer.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_frames_per_s"


def value(snap):
    return per_unit_ms(snap, ("train.loss_sync",))


def read(r):
    return value(snapshot())
