"""The device rule of the port's entry points.

Entry points (``VideoEditor``, the model builders) run on the GPU unless
the caller asks for the CPU by passing ``device="cpu"``. When no GPU is
present and none was asked away, they raise instead of quietly running on
the CPU: a CPU run of the full-width model would take hours and say
nothing about the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "insv2v_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
