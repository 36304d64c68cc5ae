"""The program's own launch counters of its hand-written kernels (each
wrapper counts its forward launches), read around a profiled stretch."""

from __future__ import annotations

from typing import Dict


def launch_counters() -> Dict[str, int]:
    from insv2v_torch.ops import attention, fused_ff, fused_norm

    fns = (attention.flash_attention, attention.flash_attention_headfold,
           fused_ff.fused_geglu_ff, attention.temporal_attention, fused_norm.fused_layer_norm)
    return {f.__name__: f.launches for f in fns}
