"""Host milliseconds a microbatch in ``torch.autograd.grad`` (``train.backward``:
the backward to the motion modules, remat's reruns and the kernels'
nested autograd with it), summed over a step and divided by its
microbatches; the median over the run's steps (steps the profiler ran
over left out)."""

from program_spans import per_unit_ms, snapshot

LAYER = "trainer (training/trainer.py)"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "train_frames_per_s"


def value(snap):
    return per_unit_ms(snap, ("train.backward",), per="train.backward")


def read(r):
    return value(snapshot())
