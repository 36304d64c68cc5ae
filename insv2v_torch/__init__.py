"""PyTorch/CUDA port of insv2v: the dual-CFG sliding-window video edit.

Layout mirrors the JAX package by name: ``ops/`` (norms, embeddings,
attention, fused FF), ``models/`` (UNet3D, VAE, CLIP text), ``diffusion/``
(schedules, samplers, the ``VideoEditor`` pipeline), ``text/``, ``utils/``,
plus ``csrc/`` (the hand-written Hopper kernels) and ``kernels/`` (their
build and ctypes bindings). Imports torch and numpy, never jax.
"""

from insv2v_torch._device import resolve_device

__all__ = ["resolve_device", "VideoEditor"]


def __getattr__(name):
    if name == "VideoEditor":
        from insv2v_torch.diffusion.pipeline import VideoEditor

        return VideoEditor
    raise AttributeError(name)
