"""The edit driver: one client in a closed loop, whole video edits back to
back through the port's ``VideoEditor.__call__``.

A unit is one edit. Its inputs come from the run's seed and the edit's
index: the input video (a smooth moving pattern, as the smoke run makes
it), the edit prompt (drawn from the traffic's list) and every standard
normal of the editor's ``noise`` seam. The driver records, at sizes it
draws from the seed before the window, what the timed path produced:
the text embeddings and the VAE latents each window's UNet calls carry,
the chain's latent before and after a few steps of each window with
those steps' UNet outputs, the latent entering each window's last step,
the latents handed to the decoder and the edited frames. After the window, ``check`` holds one edit, drawn from
the seed, to the float32 reference (``reference/insv2v.py``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from counters import launch_counters
from harness import Readings, derive_seed, log, seeded_weights
from reference import insv2v as ref
from reference.ops import precision, rel, strict_fp32
from work.kernels import unet3d_launches

# the profiled stretch of the traced run: UNet steps [PROFILE_FROM, +PROFILE_STEPS)
# of an edit's first window, each with its guidance and DDIM update, then
# HOST_STEPS more with the host's ops traced
PROFILE_FROM, PROFILE_STEPS, HOST_STEPS = 5, 10, 3


class _StopEdit(Exception):
    """Ends the profiled edit once its stretch is over."""


def edit_frames(seed: int, f: int, hgt: int, wid: int) -> np.ndarray:
    """A smooth moving pattern in [-1, 1] (F, H, W, 3) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, hgt), torch.linspace(-1, 1, wid),
                            indexing="ij")
    phase = torch.rand(3, generator=gen) * 6.28
    tt = torch.arange(f).float()[:, None, None, None] * 0.1
    frames = torch.sin(3 * xx[None, ..., None] + 2 * yy[None, ..., None] + tt + phase)
    return (0.8 * frames).float().numpy()


class Noise:
    """The editor's noise seam: float32 standard normals from one seeded
    generator on the device, each draw kept for the reference."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device
        self.draws: List[tuple] = []

    def __call__(self, kind: str, shape) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        self.draws.append((kind, x))
        return x


class Record:
    """What one edit's timed path produced, as far as ``check`` reads it."""

    def __init__(self, k: int, frames, prompt: str, noise: Noise, steps: set):
        self.k, self.frames, self.prompt, self.noise = k, frames, prompt, noise
        self.steps = steps            # (window, step) pairs whose in/out are kept
        self.calls = 0
        self.ctx: Optional[torch.Tensor] = None
        self.cond: Dict[int, torch.Tensor] = {}    # window -> its VAE latents
        self.lat: Dict[tuple, torch.Tensor] = {}   # (window, step) -> latent entering it
        # (each window's last step is kept too: its update is the window's output)
        self.eps: Dict[tuple, torch.Tensor] = {}   # (window, step) -> the UNet's output
        self.decode_in: Optional[torch.Tensor] = None
        self.output: Optional[np.ndarray] = None


class Driver:
    """Set-up, units and check of an edit cell (``traffic/<name>.json``)."""

    unit = "edit"

    def __init__(self, cell, seed: int, device="cuda", trace: bool = False):
        self.cell, self.seed, self.trace = cell, int(seed), trace
        self.device = torch.device(device)
        t = cell.traffic
        self.t = t
        self.cfg = cell.config
        self.dtype = getattr(torch, self.cfg["dtype"])
        with open(cell.path(t["prompts"])) as f:
            self.prompts = [ln.strip() for ln in f if ln.strip()]
        self.records: List[Record] = []
        self.timings: List[dict] = []
        self.windows = ref.window_windows(t["frames"], t["frames_per_window"],
                                          t["num_ref_frames"])
        self.correct_until = math.ceil(t["noise_correct_step"] * t["steps"])
        self._profile = None

    # --- set-up --------------------------------------------------------------

    def _models(self):
        from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
        from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
        from insv2v_torch.models.vae import AutoencoderKL, VaeConfig

        c = self.cfg
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        with torch.device("meta"):
            return {"unet": UNet3DConditionModel(UNetConfig(**tup(c["unet"]))),
                    "vae": AutoencoderKL(VaeConfig(**tup(c["vae"]))),
                    "text": ClipTextEncoder(ClipTextConfig(**c["text"]))}

    def setup(self):
        from harness import load_weights
        from insv2v_torch.diffusion.pipeline import VideoEditor
        from insv2v_torch.text.tokenizer import HashTokenizer

        t0 = time.perf_counter()
        models = self._models()
        self.weights = {name: seeded_weights(m, derive_seed(self.seed, name), self.device,
                                             self.dtype) for name, m in models.items()}
        for name, m in models.items():
            load_weights(m, self.weights[name])
        self.models = models
        log(f"weights: {sum(v.numel() for w in self.weights.values() for v in w.values()) / 1e6:.1f}"
            f" M parameters in {self.dtype} on {self.device}, "
            f"{time.perf_counter() - t0:.2f} s")
        t = self.t
        kw = dict(tokenizer=HashTokenizer(), scheduler=t["scheduler"], device=self.device,
                  dtype=self.dtype, scale_factor=self.cfg["scale_factor"],
                  beta_schedule_kwargs=self.cfg["diffusion"])
        self.editor = VideoEditor(models["unet"], models["vae"], models["text"],
                                  num_steps=t["steps"], **kw)
        self._hook(self.editor)
        # every shape of the window once: the same windows, the VAE's encode
        # and decode chunks and the text encoder, on a two-step chain
        warm = VideoEditor(models["unet"], models["vae"], models["text"], num_steps=2, **kw)
        t0 = time.perf_counter()
        warm(edit_frames(0, t["frames"], t["height"], t["width"]), self.prompts[0],
             **self._edit_kwargs(), noise=Noise(0, self.device))
        torch.cuda.synchronize() if self.device.type == "cuda" else None
        log(f"warm-up edit (2 steps a window): {time.perf_counter() - t0:.2f} s")

    def _edit_kwargs(self) -> dict:
        t = self.t
        return dict(text_cfg=t["text_cfg"], video_cfg=t["video_cfg"],
                    frames_per_window=t["frames_per_window"], num_ref_frames=t["num_ref_frames"],
                    noise_correct_step=t["noise_correct_step"], use_motion_compensation=False)

    def _hook(self, editor):
        """Record the timed path's state at the drawn steps (one clone a
        recorded step) and, in the profiled edit, start and stop the
        profiler at its stretch."""
        unet_call, decode = editor._unet, editor.decode_latents
        steps = self.t["steps"]

        def _unet(sample, t, ctx, video_start_index):
            rec, p = self._rec, self._profile
            w, i = divmod(rec.calls, steps) if rec is not None else (0, 0)
            if p is not None:
                call, p.calls = p.calls, p.calls + 1
                if call >= PROFILE_FROM and p.mark(call - PROFILE_FROM):
                    raise _StopEdit
            out = unet_call(sample, t, ctx, video_start_index)
            if rec is not None:
                rec.calls += 1
                if i == 0:
                    rec.ctx = ctx.clone() if rec.ctx is None else rec.ctx
                    rec.cond[w] = sample[1, ..., 4:].clone()
                if (w, i) in rec.steps or (w, i - 1) in rec.steps or i == steps - 1:
                    rec.lat[(w, i)] = sample[0, ..., :4].clone()
                if (w, i) in rec.steps:
                    rec.eps[(w, i)] = out.clone()
            return out

        def _decode(latents, chunk: int = 8):
            if self._rec is not None:
                self._rec.decode_in = latents.clone()
            return decode(latents, chunk)

        editor._unet, editor.decode_latents = _unet, _decode
        self._rec: Optional[Record] = None

    # --- units -----------------------------------------------------------------

    def _draw_steps(self, k: int) -> set:
        """Two checked steps a window: one while the refs anchor the chain,
        one after (each with a following step to compare)."""
        rs = np.random.RandomState(derive_seed(self.seed, "steps", k) % 2 ** 32)
        s, cut = self.t["steps"], self.correct_until
        return {(w, int(rs.randint(lo, hi))) for w in range(len(self.windows))
                for lo, hi in ((0, cut), (cut, s - 1))}

    def run_unit(self, k: int) -> int:
        t = self.t
        frames = edit_frames(derive_seed(self.seed, "frames", k), t["frames"], t["height"],
                             t["width"])
        rs = np.random.RandomState(derive_seed(self.seed, "prompt", k) % 2 ** 32)
        prompt = self.prompts[rs.randint(len(self.prompts))]
        noise = Noise(derive_seed(self.seed, "noise", k), self.device)
        self._rec = rec = Record(k, frames, prompt, noise, self._draw_steps(k))
        timings = {} if self.trace else None
        rec.output = self.editor(frames, prompt, **self._edit_kwargs(), noise=noise,
                                 timings=timings)
        self._rec = None
        self.records.append(rec)
        if timings is not None:
            self.timings.append(timings)
        return t["frames"]

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        return {"edit_fps": units * self.t["frames"] / wall}

    def describe(self, units: int, wall: float) -> List[str]:
        lines = [f"edits {units} in {wall:.3f} s: {wall / units:.3f} s an edit"]
        for k, tm in enumerate(self.timings):
            lines.append(f"edit {k} stages (s): " + ", ".join(f"{a} {b:.3f}" for a, b in tm.items()))
        return lines

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        """Spans of the traced window, then one profiled stretch of whole
        UNet steps of a further edit."""
        from harness import Stretch

        steps = self.t["steps"] * len(self.windows)
        sp = {}
        for tm in self.timings:
            for k, v in tm.items():
                key = "window" if k.startswith("window_") else k
                sp[key] = sp.get(key, 0.0) + v
        r.spans, r.counts = sp, {"unet_steps": steps * units}
        r.unit_wall_ms = 1e3 * sp["window"] / (steps * units)
        r.flops_per_unit = self.flops_per_edit()
        self._profile = Stretch(launch_counters, PROFILE_STEPS, HOST_STEPS)
        self._profile.calls = 0
        t = self.t
        try:
            self.editor(edit_frames(derive_seed(self.seed, "profile"), t["frames"], t["height"],
                                    t["width"]), self.prompts[0], **self._edit_kwargs(),
                        noise=Noise(derive_seed(self.seed, "profile"), self.device))
            raise RuntimeError("the profiled edit ended before its stretch")
        except _StopEdit:
            pass
        p, self._profile = self._profile, None
        p.fill(r)
        per_call = unet3d_launches(self.cfg["unet"], 3, t["frames_per_window"],
                                   t["height"] // 8, t["width"] // 8)
        r.work = {k: v * PROFILE_STEPS for k, v in per_call.items()}
        log(f"profiled stretch: {PROFILE_STEPS} UNet steps, {len(r.trace.device_ops)} device ops, "
            f"{len(r.trace.host_ops)} host ops, launches {r.launches}")

    def flops_per_edit(self) -> float:
        """Model FLOPs of one edit, counted over the float32 reference on
        the meta device: two text encodes, the VAE encode of every frame,
        every 3-way UNet call and the VAE decode of every frame."""
        from torch.utils.flop_counter import FlopCounterMode

        t, c = self.t, self.cfg
        meta = {n: {k: torch.empty(v.shape, device="meta") for k, v in w.items()}
                for n, w in self.weights.items()}
        f, h, w = t["frames"], t["height"], t["width"]
        fw = t["frames_per_window"]
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            ids = torch.zeros((2, 77), dtype=torch.long, device="meta")
            ref.clip_text(meta["text"], ids, c["text"]["num_layers"], c["text"]["num_heads"])
            ref.vae_moments(meta["vae"], torch.empty((f, h, w, 3), device="meta"), vl, vb)
            ref.vae_decode(meta["vae"], torch.empty((f, h // 8, w // 8, 4), device="meta"), vl, vb)
        fixed = counter.get_total_flops()
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            ref.unet3d(meta["unet"], c["unet"], torch.empty((3, fw, h // 8, w // 8, 8), device="meta"),
                       torch.zeros(3, dtype=torch.long, device="meta"),
                       torch.empty((3, 77, c["unet"]["cross_attention_dim"]), device="meta"), 0)
        calls = t["steps"] * len(self.windows)
        return float(fixed + calls * counter.get_total_flops())

    # --- the check ---------------------------------------------------------------

    def release(self):
        """Drop the program's state; the benchmark's weights stay."""
        for name in ("editor", "models"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def pick(self) -> Record:
        rs = np.random.RandomState(derive_seed(self.seed, "check") % 2 ** 32)
        return self.records[rs.randint(len(self.records))]

    def check(self, rec: Optional[Record] = None, control: bool = False):
        """The reference's numbers for one edit: {name: rel L2} for the
        program and, with ``control``, for the reference one precision
        lower (fp8) in the program's place."""
        strict_fp32()
        rec = rec or self.pick()
        c, t, W, dev = self.cfg, self.t, self.weights, self.device
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        tl, th = c["text"]["num_layers"], c["text"]["num_heads"]
        tables = ref.ddim_tables(t["steps"], **{k: c["diffusion"][k] for k in
                                                ("beta_start", "beta_end")})
        prog: Dict[str, float] = {}
        ctrl: Dict[str, float] = {}
        worst = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
        with torch.no_grad():
            ids = torch.as_tensor(ref.hash_token_ids([rec.prompt, ""]), device=dev)
            text = lambda: ref.clip_text(W["text"], ids, tl, th)
            ctx = text()
            worst(prog, "text", rel(torch.stack([rec.ctx[2], rec.ctx[0]]), ctx))
            draws = [x for kind, x in rec.noise.draws if kind == "encode"]
            frames = torch.as_tensor(rec.frames, device=dev)
            # one posterior draw a chunk of frames, as the editor drew them
            starts = np.cumsum([0] + [d.shape[0] for d in draws[:-1]])
            encode = lambda: torch.cat([ref.vae_sample(W["vae"], frames[i: i + d.shape[0]], d,
                                                       vl, vb) for i, d in zip(starts, draws)])
            cond = encode()
            got = torch.cat([rec.cond[w] for w in range(len(self.windows))])
            want = torch.cat([cond[s0: s0 + s_n] for s0, s_n, _ in self.windows])
            worst(prog, "vae_encode", rel(got, want))
            if control:
                with precision("fp8"):
                    worst(ctrl, "text", rel(text(), ctx))
                    worst(ctrl, "vae_encode", rel(encode(), cond))
            latents = rec.decode_in.reshape((1, t["frames"]) + rec.decode_in.shape[1:])
            for (w, i) in sorted(rec.steps):
                s0, s_n, r_n = self.windows[w]
                lat = rec.lat[(w, i)].float()[None]
                latent_ref = None
                if r_n:
                    latent_ref = torch.cat([latents[:, s0: s0 + r_n].float(),
                                            torch.zeros_like(lat[:, r_n:])], dim=1)
                step = lambda: ref.edit_step(
                    W["unet"], c["unet"], tables, i, lat, cond[s0: s0 + s_n][None], ctx[1:2],
                    ctx[0:1], s0, latent_ref, r_n, self.correct_until, t["text_cfg"],
                    t["video_cfg"])
                # "step": the guided, anchored eps each side's DDIM update used
                # (the program's recovered from its two states)
                e3, eps, _ = step()
                p_eps = ref.ddim_eps(tables, i, lat, rec.lat[(w, i + 1)].float()[None])
                worst(prog, "unet", rel(rec.eps[(w, i)].float(), e3))
                worst(prog, "step", rel(p_eps, eps))
                log(f"check window {w} step {i}: unet {rel(rec.eps[(w, i)].float(), e3):.4e} "
                    f"step {rel(p_eps, eps):.4e}")
                if control:
                    with precision("fp8"):
                        ce3, ceps, _ = step()
                    worst(ctrl, "unet", rel(ce3, e3))
                    worst(ctrl, "step", rel(ceps, eps))
            # "stitch": the decoder's latents against each window's last
            # update from the program's latent entering it, the new frames
            # of every window where the window writes them
            got, last, low = [], [], []
            for w, (s0, s_n, r_n) in enumerate(self.windows):
                i = t["steps"] - 1
                lat = rec.lat[(w, i)].float()[None]
                latent_ref = None
                if r_n:
                    latent_ref = torch.cat([latents[:, s0: s0 + r_n].float(),
                                            torch.zeros_like(lat[:, r_n:])], dim=1)
                step = lambda: ref.edit_step(
                    W["unet"], c["unet"], tables, i, lat, cond[s0: s0 + s_n][None], ctx[1:2],
                    ctx[0:1], s0, latent_ref, r_n, self.correct_until, t["text_cfg"],
                    t["video_cfg"])[2][:, r_n:]
                got.append(latents[:, s0 + r_n: s0 + s_n].float())
                last.append(step())
                if control:
                    with precision("fp8"):
                        low.append(step())
            worst(prog, "stitch", rel(torch.cat(got, 1), torch.cat(last, 1)))
            if control:
                worst(ctrl, "stitch", rel(torch.cat(low, 1), torch.cat(last, 1)))
            decode = lambda: ref.decode_frames(W["vae"], rec.decode_in, c["scale_factor"], vl, vb)
            frames_ref = decode()
            worst(prog, "vae_decode", rel(torch.as_tensor(rec.output, device=dev), frames_ref))
            if control:
                with precision("fp8"):
                    worst(ctrl, "vae_decode", rel(decode(), frames_ref))
        return prog, ctrl
