"""Faults planted in the program for the readings that limits are set
from (``calibrate.py --fault``) and for the CPU tests: each returns
``(owner, attribute, replacement)``, for ``setattr`` or a test's
``monkeypatch``."""

from __future__ import annotations

import dataclasses


def half_batch():
    """The trainer's accumulation over the first half of its microbatches
    only, their mean taken for the whole step's."""
    from insv2v_torch.training import trainer

    real = trainer.Trainer.accumulate_grads

    def half(self, state, batch, generator=None, draws=None):
        cfg = self.cfg
        accum, keep = cfg.accumulate_grad_batches, len(batch["prompt_ids"]) // 2
        self.cfg = dataclasses.replace(cfg, accumulate_grad_batches=accum // 2)
        try:
            return real(self, state, {k: v[:keep] for k, v in batch.items()}, generator,
                        draws[: accum // 2] if draws else None)
        finally:
            self.cfg = cfg

    return trainer.Trainer, "accumulate_grads", half


FAULTS = {"half_batch": half_batch}
