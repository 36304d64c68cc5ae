"""Checkpoints: the reference's torch weights into the port's modules, and
the training state saved and restored with ``torch.save``.

Counterpart of ``utils/checkpoint.py`` in the JAX package. The port's
modules keep the reference's torch key layout, so weights load with no
conversion beyond the reference's own wrappers:

  * a fused ``insv2v.pth`` splits by prefix: ``unet.``, ``vae.``,
    ``text_model.`` (whose FrozenCLIPEmbedder nests the CLIP model under
    ``transformer.``);
  * or the three-source layout: the SD/ip2p UNet merged with the
    AnimateDiff motion weights, ``vqvae.ckpt``, ``text.ckpt``;
  * DeepSpeed's ``_forward_module.`` prefix and Lightning's
    ``state_dict`` nesting are unwrapped; the VAE's ``loss.`` tree and the
    motion modules' ``pos_encoder.pe`` tables (regenerated from their
    size) are dropped.

The training state is the step, the float32 motion masters and the
optimizer's state (JAX: an orbax ``TrainState``), one file per step
under ``step_XXXXXXXX.pt``.

The scorer's and the flow model's weights load the same way: a HF
``CLIPModel`` state dict (``text_model.*``, ``vision_model.*``,
``visual_projection.weight``, ``text_projection.weight``; its
``position_ids`` buffers and ``logit_scale`` are dropped) and a
princeton-vl RAFT ``.pth`` (DataParallel's ``module.`` prefix stripped).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

__all__ = ["strip_prefixes", "load_torch_weights", "split_fused", "load_pipeline_state_dicts",
           "load_into", "load_clip_model_state_dict", "load_raft_state_dict",
           "save_train_state", "restore_train_state"]


def strip_prefixes(sd: Mapping, prefixes=("_forward_module.",)) -> Dict[str, torch.Tensor]:
    """Unwrap Lightning's ``state_dict`` nesting and launcher prefixes."""
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A flat state dict from a torch checkpoint file (tensors only: the
    loader refuses arbitrary pickled objects)."""
    return strip_prefixes(torch.load(path, map_location="cpu", weights_only=True))


def _port_unet(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in strip_prefixes(sd).items() if "pos_encoder.pe" not in k}


def _port_vae(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in strip_prefixes(sd).items() if not k.startswith("loss.")}


def _port_text(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k[len("transformer."):] if k.startswith("transformer.") else k: v
            for k, v in strip_prefixes(sd).items()}


def split_fused(sd: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A fused trainer checkpoint -> {'unet', 'vae', 'text'} by prefix."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"unet": {}, "vae": {}, "text": {}}
    for k, v in sd.items():
        for part, prefix in (("unet", "unet."), ("vae", "vae."), ("text", "text_model.")):
            if k.startswith(prefix):
                out[part][k[len(prefix):]] = v
    return out


def load_pipeline_state_dicts(fused_ckpt: Optional[str] = None,
                              unet_weights: Optional[str] = None,
                              motion_weights: Optional[str] = None,
                              vae_weights: Optional[str] = None,
                              text_weights: Optional[str] = None
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'unet', 'vae', 'text'} state dicts in the port's key layout, from a
    fused checkpoint or the three-source layout. Pieces not given are
    absent; the caller keeps its own initialisation for them."""
    sds: Dict[str, Dict[str, torch.Tensor]] = {}
    if fused_ckpt:
        parts = split_fused(load_torch_weights(fused_ckpt))
        for part, conv in (("unet", _port_unet), ("vae", _port_vae), ("text", _port_text)):
            if parts[part]:
                sds[part] = conv(parts[part])
        return sds
    if unet_weights:
        unet = load_torch_weights(unet_weights)
        if motion_weights:
            motion = load_torch_weights(motion_weights)
            overlap = set(unet) & set(motion)
            if overlap:
                raise ValueError(f"unexpected key overlap in merge: {sorted(overlap)[:5]}")
            unet.update(motion)
        sds["unet"] = _port_unet(unet)
    if vae_weights:
        sds["vae"] = _port_vae(load_torch_weights(vae_weights))
    if text_weights:
        sds["text"] = _port_text(load_torch_weights(text_weights))
    return sds


def load_into(models: Mapping[str, torch.nn.Module],
              sds: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Load state dicts over the models' own weights (the reference's
    ``strict=False`` semantics: keys present replace, missing keys keep
    theirs); an unknown key or a shape mismatch raises."""
    names = {"unet": "unet", "vae": "vae", "text": "text_model"}
    for part, sd in sds.items():
        module = models[names[part]]
        unexpected = set(sd) - set(module.state_dict())
        if unexpected:
            raise ValueError(f"{part}: keys the model does not have: {sorted(unexpected)[:5]}")
        module.load_state_dict(sd, strict=False)


def load_clip_model_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A HF ``CLIPModel`` checkpoint -> its state dict in the port's (HF)
    key layout, without the ``position_ids`` buffers and ``logit_scale``."""
    return {k: v for k, v in load_torch_weights(path).items()
            if not k.endswith("position_ids") and k != "logit_scale"}


def _mask_to_port_order(w: torch.Tensor) -> torch.Tensor:
    """The convex-upsampling mask head's 576 output channels (dim 0) from
    princeton-vl's order ``n*64 + u*8 + v`` to the port's
    ``(u*8 + v)*9 + n`` (n the 3x3 neighbour, (u, v) the 8x8 sub-pixel)."""
    return w.reshape((9, 64) + w.shape[1:]).transpose(0, 1).reshape(w.shape)


def load_raft_state_dict(model: torch.nn.Module, source, mask_order: str = "reference") -> None:
    """Load a princeton-vl RAFT checkpoint (a path or a state dict) into the
    port's ``RAFT``: the ``module.`` prefix stripped, every model key but
    the BatchNorms' ``num_batches_tracked`` required, no unknown key.

    ``mask_order``: how the checkpoint's ``update_block.mask.2`` orders its
    576 output channels. ``"reference"`` (the default) loads them as they
    are, the order the JAX package's ``convex_upsample`` reads, so both
    packages agree on one weight set; ``"princeton-vl"`` is the order of
    princeton-vl's ``upsample_flow`` and of its released checkpoints
    (``raft-things.pth``), permuted into the order the port reads."""
    if mask_order not in ("reference", "princeton-vl"):
        raise ValueError(f"mask_order {mask_order!r}: 'reference' or 'princeton-vl'")
    sd = load_torch_weights(source) if isinstance(source, str) else source
    sd = strip_prefixes(sd, ("_forward_module.", "module."))
    if mask_order == "princeton-vl":
        sd = {k: _mask_to_port_order(v) if k.startswith("update_block.mask.2.") else v
              for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"RAFT checkpoint: missing {missing[:5]}, unknown {unexpected[:5]}")


def save_train_state(state, ckpt_dir: str, step: Optional[int] = None,
                     optimizer_state: Optional[dict] = None) -> str:
    """The state under ``ckpt_dir/step_XXXXXXXX.pt``; returns the path.
    ``optimizer_state``: the optimizer's state dict where it is not
    ``state.optimizer.state_dict()`` (a sharded optimizer's, gathered by
    ``parallel.dist.gather_optimizer_state``)."""
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step,
                "params": {k: v.detach().cpu() for k, v in state.params.items()},
                "optimizer": (state.optimizer.state_dict() if optimizer_state is None
                              else optimizer_state)}, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(ckpt_dir_or_path: str, state):
    """Restore into ``state`` (a fresh ``TrainState`` of the same model):
    the newest ``step_*.pt`` of a directory, or the file given."""
    path = ckpt_dir_or_path
    if os.path.isdir(path):
        steps = sorted(p for p in os.listdir(path) if p.startswith("step_") and p.endswith(".pt"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = os.path.join(path, steps[-1])
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if set(saved["params"]) != set(state.params):
        raise ValueError(f"{path}: its trainable parameters differ from the model's")
    with torch.no_grad():
        for k, v in saved["params"].items():
            state.params[k].copy_(v)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
