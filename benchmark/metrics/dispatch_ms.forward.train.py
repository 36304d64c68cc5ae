"""Host milliseconds a microbatch in ``Trainer.microbatch_loss``: the
no-grad text and VAE encodes with the q-sample (``train.encode``) and the
UNet forward with the loss (``train.forward``), summed over a step and
divided by its microbatches; the median over the run's steps (the
tracer's spans; steps the profiler ran over left out)."""

from program_spans import per_unit_ms, snapshot

LAYER = "trainer (training/trainer.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_frames_per_s"


def value(snap):
    return per_unit_ms(snap, ("train.encode", "train.forward"), per="train.forward")


def read(r):
    return value(snapshot())
