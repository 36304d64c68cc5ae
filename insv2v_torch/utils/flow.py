"""Optical flow for the motion-compensated edit: the estimators and the
per-window flow stack the window sampler warps its ref-frame deltas with.

Counterpart of ``utils/flow.py`` in the JAX package. Estimators map a
query frame and a ref frame, (H, W, 3) float in [-1, 1], to the flow
(H, W, 2) = (u, v) in pixels from query to ref (the backward-warp
convention of ``ops.resize.warp_image``):

  * ``FarnebackFlow``: OpenCV's Farneback on grayscale frames, on the host;
  * ``ZeroFlow``: no motion (the flow branch then equals the mean delta
    wherever every ref covers);
  * ``RaftFlow``: the port's RAFT (``models/raft.py``) on the GPU, with
    pretrained princeton-vl weights, or seeded random ones for structure
    tests only (``allow_random=True``). Its ``batch`` method runs many
    (query, ref) pairs in one call: RAFT treats batch elements apart.

``get_flow_estimator("auto")`` keeps the JAX rule: RAFT when weights are
given (``weights_path`` or ``$INSV2V_RAFT_WEIGHTS``), else Farneback with a
loud warning that the result will not match the reference's quality.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from insv2v_torch._device import resolve_device
from insv2v_torch.models.raft import RAFT, RaftConfig
from insv2v_torch.ops.resize import resize_flow
from insv2v_torch.utils.checkpoint import load_raft_state_dict

__all__ = ["FarnebackFlow", "ZeroFlow", "RaftFlow", "get_flow_estimator", "window_flows"]

RAFT_WEIGHTS_ENV = "INSV2V_RAFT_WEIGHTS"
# (query, ref) pairs per RAFT call: bounds the encoders' half-resolution
# activations, which grow with the pairs of a call
_RAFT_PAIRS_PER_CALL = 16


class FarnebackFlow:
    """cv2.calcOpticalFlowFarneback on grayscale frames, fully offline."""

    def __init__(self, levels: int = 3, winsize: int = 21, iterations: int = 3):
        self.levels, self.winsize, self.iterations = levels, winsize, iterations

    def __call__(self, query: np.ndarray, ref: np.ndarray) -> np.ndarray:
        import cv2

        gray = lambda im: cv2.cvtColor(((np.clip(im, -1, 1) + 1) * 127.5).astype(np.uint8),
                                       cv2.COLOR_RGB2GRAY)
        return cv2.calcOpticalFlowFarneback(
            gray(query), gray(ref), None, pyr_scale=0.5, levels=self.levels,
            winsize=self.winsize, iterations=self.iterations, poly_n=5, poly_sigma=1.1,
            flags=0)


class ZeroFlow:
    """Zero displacement everywhere."""

    def __call__(self, query: np.ndarray, ref: np.ndarray) -> np.ndarray:
        return np.zeros(query.shape[:2] + (2,), dtype=np.float32)


class RaftFlow:
    """RAFT on the port's device (``cuda`` unless ``device="cpu"``), float32.

    Weights: a princeton-vl RAFT ``.pth`` from ``weights_path`` or
    ``$INSV2V_RAFT_WEIGHTS``; ``allow_random=True`` builds seeded random
    weights instead (meaningless flow, for structure tests); anything else
    raises."""

    def __init__(self, weights_path: Optional[str] = None, iters: int = 12, cfg=None,
                 allow_random: bool = False, device=None, seed: int = 0):
        self.device = resolve_device(device)
        cfg = cfg if cfg is not None else RaftConfig(iters=iters)
        weights_path = weights_path or os.environ.get(RAFT_WEIGHTS_ENV)
        if not weights_path and not allow_random:
            raise ValueError(
                f"RaftFlow requires pretrained weights: set ${RAFT_WEIGHTS_ENV} or pass "
                "weights_path= (the reference always loads pretrained RAFT). Random-init "
                "RAFT produces meaningless flow; pass allow_random=True only for structure "
                "tests, or use get_flow_estimator('auto') for the Farneback fallback.")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = RAFT(cfg)
        if weights_path:
            load_raft_state_dict(model, weights_path)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def batch(self, queries: np.ndarray, refs: np.ndarray) -> torch.Tensor:
        """queries, refs (N, H, W, 3) in [-1, 1] -> flows (N, H, W, 2) on
        the device. Frames are zero-padded at the bottom and right to
        multiples of 8, and the flow cropped back."""
        n, h, w, _ = queries.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        dev = lambda a: F.pad(torch.as_tensor(np.asarray(a, np.float32)).to(self.device),
                              (0, 0, 0, wp - w, 0, hp - h))
        outs = [self.model(dev(queries[i: i + _RAFT_PAIRS_PER_CALL]),
                           dev(refs[i: i + _RAFT_PAIRS_PER_CALL]))
                for i in range(0, n, _RAFT_PAIRS_PER_CALL)]
        return torch.cat(outs, dim=0)[:, :h, :w]

    def __call__(self, query: np.ndarray, ref: np.ndarray) -> np.ndarray:
        return self.batch(query[None], ref[None])[0].cpu().numpy()


def get_flow_estimator(kind: str = "auto", device=None, **kwargs):
    """``auto``: RAFT when ``weights_path`` or ``$INSV2V_RAFT_WEIGHTS`` is
    set, else Farneback with a warning; or ``farneback``, ``zero``,
    ``raft``. ``device`` goes to RAFT only."""
    if kind == "auto":
        if kwargs.get("weights_path") or os.environ.get(RAFT_WEIGHTS_ENV):
            return RaftFlow(device=device, **kwargs)
        warnings.warn(
            f"{RAFT_WEIGHTS_ENV} is not set: falling back to Farneback optical flow. The "
            "reference's motion compensation uses RAFT; Farneback results will NOT "
            f"reproduce reference quality. Point {RAFT_WEIGHTS_ENV} at a princeton-vl "
            "raft-large .pth.")
        return FarnebackFlow()
    if kind == "farneback":
        return FarnebackFlow(**kwargs)
    if kind == "zero":
        return ZeroFlow()
    if kind == "raft":
        return RaftFlow(device=device, **kwargs)
    raise ValueError(f"unknown flow estimator {kind!r}")


def window_flows(estimator, frames: np.ndarray, num_ref: int, latent_hw) -> torch.Tensor:
    """The flow stack of one window: frames (F, H, W, 3), the first
    ``num_ref`` of them refs -> (F, R, h, w, 2) float32 at latent
    resolution (vectors scaled), from each query frame to each ref; rows
    below ``num_ref`` stay zero (those frames take their own delta). An
    estimator with a ``batch`` method gets every pair in one call; any
    other callable gets them one by one."""
    f = frames.shape[0]
    h, w = latent_hw
    q_idx = [q for q in range(num_ref, f) for _ in range(num_ref)]
    r_idx = [r for _ in range(num_ref, f) for r in range(num_ref)]
    if not q_idx:
        return torch.zeros((f, num_ref, h, w, 2))
    if hasattr(estimator, "batch"):
        pair_flows = estimator.batch(frames[q_idx], frames[r_idx])
    else:
        pair_flows = torch.as_tensor(np.stack(
            [np.asarray(estimator(frames[q], frames[r]), np.float32)
             for q, r in zip(q_idx, r_idx)]))
    small = resize_flow(pair_flows, h, w)
    flows = small.new_zeros((f, num_ref, h, w, 2))
    flows[num_ref:] = small.reshape(f - num_ref, num_ref, h, w, 2)
    return flows
