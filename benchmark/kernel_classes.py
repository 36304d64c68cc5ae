"""Kernel classes by name fragment, matched in this order; a kernel that
matches none is "other elementwise". The port's kernels first (A/A' in
``flash_attn.cu``, B in ``geglu_ff.cu``, C in ``temporal_attn.cu``, D in
``layer_norm.cu``), then the library's."""

from __future__ import annotations

CLASSES = (
    ("flash", ("flash_fwd",)),
    ("ff", ("ff_gate", "ff_out")),
    ("temporal", ("temporal_attn",)),
    ("layer_norm_d", ("namespace)::layer_norm_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd", "dgrad", "wgrad")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy", "nchwtonhwc", "nhwctonchw", "memcpy", "memset")),
    ("norms", ("norm", "welford", "reduce")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, frags in CLASSES if any(f in low for f in frags)), "other elementwise")
