"""Plain float32 reference of InsV2V's motion-module training
(amazon-science/instruct-video-to-video, configs/instruct_v2v.yaml and
its trainer): the prompt-to-prompt video dataset with its camera-motion
augmentation (dataset/videoP2P.py) and the batch draw, then steps of
the epsilon loss on the motion modules with the frozen CLIP text tower,
VAE and UNet, gradient accumulation and Adam.

The batches are rebuilt from the dataset's files with the same random
draws, through OpenCV as the dataset reads and resizes frames; the
models are those of ``insv2v.py``. Imports nothing of the program.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import insv2v as ref

GATES = dict(sim_0=0.2, sim_1=0.2, sim_dir=0.2, sim_image=0.5)


# --- the dataset and the batch draw ------------------------------------------

def _read(path: str) -> np.ndarray:
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def _translate(dh: float, dw: float, images: np.ndarray, n: int) -> np.ndarray:
    """A crop of (H - |dh|, W - |dw|) whose centre travels linearly over the
    frames, each crop resized back (bicubic)."""
    import cv2

    H, W = images.shape[1:3]
    ch, cw = int(H - abs(dh)), int(W - abs(dw))
    if dh > 0:
        h0, h1 = (H - dh) / 2, (H - dh) / 2 + dh
    else:
        h1 = H - (H + dh) / 2
        h0 = h1 + dh
    if dw > 0:
        w0, w1 = (W - dw) / 2, (W - dw) / 2 + dw
    else:
        w1 = W - (W + dw) / 2
        w0 = w1 + dw
    cxs, cys = np.linspace(w0, w1, n), np.linspace(h0, h1, n)
    if dh < 0:
        cys = cys[::-1]
    if dw < 0:
        cxs = cxs[::-1]
    out = []
    for img, cx, cy in zip(images, cxs, cys):
        x0, y0 = int(cx - cw / 2), int(cy - ch / 2)
        out.append(cv2.resize(img[y0: y0 + ch, x0: x0 + cw], (W, H),
                              interpolation=cv2.INTER_CUBIC))
    return np.stack(out)


def _zoom(images: np.ndarray, scale: float, direction: str, n: int) -> np.ndarray:
    """A zoom from 1 to ``scale`` over the frames (reversed for "out"),
    each frame resized up (bicubic) and centre-cropped; none below 1.02."""
    import cv2

    if scale <= 1.02:
        return images
    H, W = images.shape[1:3]
    scales = np.linspace(1.0, scale, n)
    if direction == "out":
        scales = scales[::-1]
    out = []
    for img, s in zip(images, scales):
        z = cv2.resize(img, (int(W * s), int(H * s)), interpolation=cv2.INTER_CUBIC)
        y0, x0 = (z.shape[0] - H) // 2, (z.shape[1] - W) // 2
        out.append(z[y0: y0 + H, x0: x0 + W])
    return np.stack(out)


class PairDataset:
    """Sample folders under ``root`` (sorted): ``image/{seed}_{0|1}_{i:04d}.jpg``
    over 16 frames, ``prompt.json``, ``metadata.jsonl``; an item draws an
    accepted seed, a window start, then translation and zoom with the
    given probabilities, in that order from ``rng``."""

    def __init__(self, root: str, num_frames: int, rng, zoom_ratio: float, max_zoom: float,
                 translation_ratio: float, translation_range: Sequence[float]):
        self.folders = [os.path.join(root, f) for f in sorted(os.listdir(root))]
        self.n, self.rng = num_frames, rng
        self.zoom_ratio, self.max_zoom = zoom_ratio, max_zoom
        self.translation_ratio, self.translation_range = translation_ratio, tuple(translation_range)

    def __len__(self) -> int:
        return len(self.folders)

    def __getitem__(self, idx: int) -> Dict:
        folder, rng = self.folders[idx], self.rng
        with open(os.path.join(folder, "metadata.jsonl")) as f:
            metas = [json.loads(ln) for ln in f if ln.strip()]
        seeds = [m["seed"] for m in metas if all(m.get(k, 0) > v for k, v in GATES.items())]
        seed = seeds[rng.randint(len(seeds))]
        with open(os.path.join(folder, "prompt.json")) as f:
            prompt = json.load(f)
        start = rng.randint(0, 16 - self.n + 1)
        frames = lambda tag: np.stack([_read(os.path.join(folder, "image", f"{seed}_{tag}_{i:04d}.jpg"))
                                       for i in range(start, start + self.n)])
        inp, out = frames(0), frames(1)
        H, W = inp.shape[1:3]
        if rng.random_sample() < self.translation_ratio:
            dh = rng.uniform(*self.translation_range) * H * rng.choice([-1, 1])
            dw = rng.uniform(*self.translation_range) * W * rng.choice([-1, 1])
            inp, out = _translate(dh, dw, inp, self.n), _translate(dh, dw, out, self.n)
        if rng.random_sample() < self.zoom_ratio:
            scale = rng.uniform(1.0, self.max_zoom)
            direction = rng.choice(["in", "out"])
            inp, out = _zoom(inp, scale, direction, self.n), _zoom(out, scale, direction, self.n)
        return {"input_video": inp * 2.0 - 1.0, "edited_video": out * 2.0 - 1.0,
                "input_prompt": prompt["input"], "output_prompt": prompt["output"],
                "edit_prompt": prompt["edit"]}


def batches(dataset: PairDataset, batch_size: int, prompt_key: str, rng, count: int) -> List[Dict]:
    """The first ``count`` batches: ``batch_size`` items drawn with
    replacement, stacked, the prompts hash-tokenised."""
    out = []
    for _ in range(count):
        items = [dataset[int(i)] for i in rng.randint(0, len(dataset), size=batch_size)]
        out.append({"input_video": np.stack([it["input_video"] for it in items]).astype(np.float32),
                    "edited_video": np.stack([it["edited_video"] for it in items]).astype(np.float32),
                    "prompt_ids": ref.hash_token_ids([it[prompt_key] for it in items])})
    return out


# --- the steps -------------------------------------------------------------------

def alphas_cumprod(train_steps: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012) -> np.ndarray:
    return np.cumprod(1.0 - np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps) ** 2)


def train_steps(W: Dict[str, Dict[str, torch.Tensor]], cfg: dict, tcfg: dict, batch_list,
                draws, motion_init: Dict[str, torch.Tensor], steps: int) -> Dict:
    """``steps`` optimizer steps from the motion parameters ``motion_init``:
    each the mean epsilon loss and mean gradient over ``tcfg['accumulate']``
    microbatches (frozen text, VAE and the rest of the UNet), then Adam.
    Returns each step's loss, the first step's gradient and the motion
    parameters after the last step, per leaf."""
    dev = next(iter(motion_init.values())).device
    ac = torch.as_tensor(alphas_cumprod(), device=dev)
    motion = {k: v.detach().float().clone().requires_grad_(True) for k, v in motion_init.items()}
    Wu = dict(W["unet"])
    Wu.update(motion)
    b1, b2 = tcfg["betas"]
    m = {k: torch.zeros_like(v) for k, v in motion.items()}
    v2 = {k: torch.zeros_like(v) for k, v in motion.items()}
    vl, vb = len(cfg["vae"]["ch_mult"]), cfg["vae"]["num_res_blocks"]
    text_layers, text_heads = cfg["text"]["num_layers"], cfg["text"]["num_heads"]
    accum, losses, first = tcfg["accumulate"], [], None
    keys = list(motion)
    for s in range(steps):
        g_sum = {k: torch.zeros_like(v) for k, v in motion.items()}
        loss_sum = 0.0
        mb = len(batch_list[s]["prompt_ids"]) // accum
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            d = draws[s][i]
            with torch.no_grad():
                ids = torch.as_tensor(batch_list[s]["prompt_ids"][rows], device=dev)
                text = ref.clip_text(W["text"], ids, text_layers, text_heads)
                encode = lambda video, eps: ref.vae_sample(
                    W["vae"], video.reshape((-1,) + video.shape[2:]), eps, vl, vb).reshape(
                    video.shape[:2] + eps.shape[1:])
                inp = torch.as_tensor(batch_list[s]["input_video"][rows], device=dev)
                edited = torch.as_tensor(batch_list[s]["edited_video"][rows], device=dev)
                cond = encode(inp, d["enc_cond"])
                cond = torch.where(d["drop"].reshape(-1, 1, 1, 1, 1), 0.0, cond)
                x0 = encode(edited, d["enc_edit"]) * cfg["scale_factor"]
                a = ac[d["t"]].float().reshape(-1, 1, 1, 1, 1)
                xt = a.sqrt() * x0 + (1.0 - a).sqrt() * d["eps"]
            pred = ref.unet3d(Wu, cfg["unet"], torch.cat([xt, cond], dim=-1), d["t"], text, 0)
            loss = ((pred - d["eps"]) ** 2).mean()
            grads = torch.autograd.grad(loss, [motion[k] for k in keys])
            for k, g in zip(keys, grads):
                g_sum[k] += g
            loss_sum += float(loss.detach())
        grads = {k: g / accum for k, g in g_sum.items()}
        losses.append(loss_sum / accum)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in keys:
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** (s + 1))
                v_hat = v2[k] / (1 - b2 ** (s + 1))
                motion[k] -= tcfg["lr"] * m_hat / (v_hat.sqrt() + 1e-8)
    return {"losses": losses, "grad": first, "params": {k: v.detach() for k, v in motion.items()}}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """Over the leaves (those ``keep`` holds, if given): |got - want| over
    the larger of the leaf's own ``want`` and the median leaf's."""
    keys = [k for k in want if keep is None or k in keep]
    median = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys)
