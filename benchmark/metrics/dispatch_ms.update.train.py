"""Host milliseconds a step in its update: the per-leaf gradient adds of
every microbatch (``train.accumulate``), the all-reduce (``train.all_reduce``,
data-parallel only), the optimizer's step and zero_grad
(``train.optimizer``) and the copy of the masters into the model
(``train.push_params``); the median over the run's steps (steps the
profiler ran over left out)."""

from program_spans import per_unit_ms, snapshot

LAYER = "trainer (training/trainer.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_frames_per_s"
NAMES = ("train.accumulate", "train.all_reduce", "train.optimizer", "train.push_params")


def value(snap):
    return per_unit_ms(snap, NAMES)


def read(r):
    return value(snapshot())
