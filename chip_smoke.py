#!/usr/bin/env python3
"""GPU smoke run of the insv2v_torch port: builds the CUDA kernels from the
checkout, holds each against its plain PyTorch twin at the main path's
shapes, checks a full-width UNet call against the CPU float32 run, and
drives the full-width dual-CFG video edit through ``VideoEditor``.

    python3 chip_smoke.py                # every phase, one GPU
    python3 chip_smoke.py --only env,build,parity

Phases: env, build, parity (kernels A, B, C against their twins, with
times, bounds and the one-call PyTorch yardstick), unet (GPU bf16 vs CPU
float32 on a small latent), edit (32 frames at 256x384, 3 windows, 50-step
DDIM: the workload bench.py times for the JAX package), profile (one UNet
call of the edit under torch.profiler: device time by kernel class and the
device's idle share).
It prints the card and its power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero with no result line. Weights are random from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel A: UNet attn1 at levels 0 and 1, then the VAE mid-block attention
# (encode chunks of 16 frames, decode chunks of 8) at 256x384
FLASH_SHAPES = [(48, 8, 1536, 40), (48, 8, 384, 80), (16, 1, 1536, 512), (8, 1, 1536, 512)]
# kernel B: (rows, C) of every spatial and motion FF at 48 frames of 32x48
FF_SHAPES = [(73728, 320), (18432, 640), (4608, 1280), (1152, 1280)]
# kernel C: (B, P, F, heads, e) of the motion modules at levels 0..3
TEMPORAL_SHAPES = [(3, 1536, 16, 8, 40), (3, 384, 16, 8, 80), (3, 96, 16, 8, 160),
                   (3, 24, 16, 8, 160)]
EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH = 32, 256, 384  # bench.py's workload
TOL = {  # max |kernel - f32 twin|, bf16-level: 8 mantissa bits of O(1) outputs
    "flash_attention": 2e-2, "fused_geglu_ff": 6e-2, "temporal_attention": 2e-2}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from insv2v_torch.kernels import build

    t0 = time.perf_counter()
    per = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in per.items()))


def _entry(name, source, replaces, rows):
    """One kernels-line entry: the numbers of the first (dominant) shape,
    the largest error over all shapes, and every shape's numbers."""
    head = rows[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rows}


def _report(name, shape, err, ms, plain_ms, lib_ms, bms, by):
    tol = TOL[name]
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"parity {name} {shape}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
        f"bound {bms:.4f} ms ({by})")
    if not (err <= tol):
        raise AssertionError(f"{name} {shape}: error {err} above {tol}")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}


def phase_parity(gen):
    import torch.nn.functional as F

    from insv2v_torch.ops.attention import (flash_attention, flash_attention_reference,
                                            temporal_attention, temporal_attention_reference)
    from insv2v_torch.ops.fused_ff import fused_geglu_ff, geglu_ff_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale
                                 ).to(torch.bfloat16)
    entries = []

    rows = []
    for shape in FLASH_SHAPES:
        b, h, s, d = shape
        q, k, v = (rnd(b, h, s, d) for _ in range(3))
        out = flash_attention(q, k, v)
        ref = flash_attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        ms = time_ms(lambda: flash_attention(q, k, v), 10)
        plain = time_ms(lambda: flash_attention_reference(q, k, v), 3)
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        bms, by = bound(4.0 * b * h * s * s * d, 2.0 * 4 * b * h * s * d)
        rows.append(_report("flash_attention", shape, err, ms, plain, lib, bms, by))
        del q, k, v, out, ref
    entries.append(_entry("flash_attention", "insv2v_torch/csrc/flash_attn.cu",
                          "insv2v_tpu/ops/attention.py:95", rows))

    rows = []
    for n, c in FF_SHAPES:
        inner = 4 * c
        x = rnd(n, c)
        lw, lb = (1.0 + 0.1 * rnd(c).float()).to(torch.bfloat16), rnd(c, scale=0.1)
        w1, b1 = rnd(2 * inner, c, scale=c ** -0.5), rnd(2 * inner, scale=0.1)
        w2, b2 = rnd(c, inner, scale=inner ** -0.5), rnd(c, scale=0.1)
        args = (x, lw, lb, w1, b1, w2, b2)
        out = fused_geglu_ff(*args)
        ref = geglu_ff_reference(*(t.float() for t in args))
        err = (out.float() - ref).abs().max().item()
        ms = time_ms(lambda: fused_geglu_ff(*args), 10)
        plain = time_ms(lambda: geglu_ff_reference(*args), 5)
        bms, by = bound(6.0 * n * c * inner,
                        2.0 * (2 * n * c + 3 * c * inner + 2 * inner + 3 * c))
        rows.append(_report("fused_geglu_ff", (n, c), err, ms, plain, None, bms, by))
    entries.append(_entry("fused_geglu_ff", "insv2v_torch/csrc/geglu_ff.cu",
                          "insv2v_tpu/ops/fused_ff.py:155", rows))

    rows = []
    for shape in TEMPORAL_SHAPES:
        b, p, f, h, e = shape
        q, k, v = (rnd(*shape) for _ in range(3))
        out = temporal_attention(q, k, v)
        ref = temporal_attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        ms = time_ms(lambda: temporal_attention(q, k, v), 20)
        plain = time_ms(lambda: temporal_attention_reference(q, k, v), 5)
        sd = lambda t: t.permute(0, 1, 3, 2, 4).reshape(b * p * h, 1, f, e)
        qs, ks, vs = sd(q), sd(k), sd(v)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), 20)
        bms, by = bound(4.0 * b * p * h * f * f * e, 2.0 * 4 * b * p * f * h * e)
        rows.append(_report("temporal_attention", shape, err, ms, plain, lib, bms, by))
    entries.append(_entry("temporal_attention", "insv2v_torch/csrc/temporal_attn.cu",
                          "insv2v_tpu/ops/attention.py:345", rows))
    torch.backends.cudnn.allow_tf32 = True
    return entries


def _wake_motion_modules(unet, gen):
    """AnimateDiff zero-inits each motion module's proj_out, which would
    hide the temporal path from any output check: give it small random
    weights instead."""
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if "temporal_transformer.proj_out" in name:
                p.copy_(torch.randn(p.shape, generator=gen, device="cpu") * 0.02)


def phase_unet(models, gen):
    """A full-width UNet call on a small latent (2 frames of 32x32: the
    S = 1024 and 256 levels take kernel A) on the GPU in bf16, against the
    same bf16-rounded weights in float32 on the CPU through the twins."""
    import copy

    unet = models["unet"]
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    x = torch.randn(1, 2, 32, 32, 8, generator=gen)
    ctx = torch.randn(1, 77, 768, generator=gen)
    t = torch.tensor([501])
    with torch.no_grad():
        ref = cpu(x, t, ctx, video_start_index=4)
        got = unet(x.cuda(), t.cuda(), ctx.cuda(), video_start_index=4).float().cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"unet full width, 2x32x32 latent: rel L2 err GPU bf16 vs CPU f32 {rel:.3e} "
        f"(tol 5e-2), max |ref| {ref.abs().max().item():.3f}")
    if not (torch.isfinite(got).all() and rel <= 5e-2):
        raise AssertionError(f"UNet GPU/CPU disagreement {rel}")
    del cpu


def phase_edit(models, args, gen):
    from insv2v_torch import VideoEditor
    from insv2v_torch.ops.attention import flash_attention, temporal_attention
    from insv2v_torch.ops.fused_ff import fused_geglu_ff
    from insv2v_torch.text.tokenizer import HashTokenizer

    editor = VideoEditor(models["unet"], models["vae"], models["text_model"],
                         tokenizer=HashTokenizer(), scheduler="ddim",
                         num_steps=args.steps, device="cuda")
    f, hgt, wid = EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH
    # a smooth moving pattern in [-1, 1], made on the device from the seed
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, hgt, device="cuda"),
                            torch.linspace(-1, 1, wid, device="cuda"), indexing="ij")
    phase = torch.rand(3, generator=gen).cuda() * 6.28
    tt = torch.arange(f, device="cuda").float()[:, None, None, None] * 0.1
    frames = torch.sin(3 * xx[None, ..., None] + 2 * yy[None, ..., None] + tt + phase)
    frames = (0.8 * frames).float().cpu().numpy()
    from insv2v_torch.diffusion.samplers import split_windows

    windows = split_windows(f, 16, 4)
    log(f"edit: {f} frames {hgt}x{wid}, DDIM {args.steps} steps, "
        f"{len(windows)} windows, dual CFG (3x batch = {3 * 16} frames per UNet call)")
    kernels = (flash_attention, fused_geglu_ff, temporal_attention)
    for kfn in kernels:
        kfn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    out = editor(frames, "make it snowy", frames_per_window=16, num_ref_frames=4,
                 seed=args.seed, timings=timings)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    log("edit stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f"; total {wall:.3f}")
    win = [v for k, v in timings.items() if k.startswith("window_")]
    log(f"edit per window {sum(win) / len(win):.3f} s, per UNet step "
        f"{sum(win) / (len(win) * args.steps):.4f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    calls = len(windows) * args.steps
    vae_chunks = math.ceil(f / 16) + math.ceil(f / 8)
    log(f"launches in the edit: {counts}; per UNet call: flash "
        f"{(counts['flash_attention'] - vae_chunks) / calls:g} (+{vae_chunks} VAE), "
        f"ff {counts['fused_geglu_ff'] / calls:g}, "
        f"temporal {counts['temporal_attention'] / calls:g}")
    if out.shape != (f, hgt, wid, 3) or not bool(torch.isfinite(torch.from_numpy(out)).all()):
        raise AssertionError(f"edit output shape {out.shape} or non-finite values")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"edit output: shape {out.shape}, range [{out.min():.3f}, {out.max():.3f}], "
        f"std {out.std():.4f}")
    return counts


PROFILE_CLASSES = (  # kernel-name fragments, matched in this order
    ("kernel A (flash)", ("flash_fwd",)), ("kernel B (ff)", ("geglu_ff",)),
    ("kernel C (temporal)", ("temporal_attn",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def phase_profile(models, gen):
    """Where one UNet call of the edit (3 x 16 frames of 32x48) spends its
    device time: torch.profiler over one call, kernel time summed by class,
    and the device's busy share of the call's synchronised wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    unet = models["unet"]
    x = torch.randn(3, 16, 32, 48, 8, generator=gen).cuda().bfloat16()
    ctx = torch.randn(3, 77, 768, generator=gen).cuda().bfloat16()
    t = torch.full((3,), 501, device="cuda")
    call = lambda: unet(x, t, ctx, video_start_index=0)
    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        log("profile: the profiler recorded no device time; breakdown not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class = {}
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c, frags in PROFILE_CLASSES if any(f in name for f in frags)),
                   "other (norms, elementwise, copies)")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    log(f"profile: one UNet call {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}); by class: "
        + ", ".join(f"{c} {ms:.2f} ms" for c, ms in sorted(by_class.items(),
                                                           key=lambda kv: -kv[1])))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d} calls  "
            f"{e.key[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="env,build,parity,unet,edit,profile")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.only.split(",")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import insv2v_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the insv2v_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    smi = phase_env()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cpu_gen = torch.Generator().manual_seed(args.seed)
    entries, counts = [], None
    if "build" in phases:
        phase_build()
    if "parity" in phases:
        entries = phase_parity(gen)
    if {"unet", "edit", "profile"} & set(phases):
        from insv2v_torch.utils.factory import build_models

        t0 = time.perf_counter()
        models = build_models(device="cuda", dtype=torch.bfloat16, seed=args.seed)
        _wake_motion_modules(models["unet"], cpu_gen)
        n = sum(p.numel() for m in models.values() for p in m.parameters())
        log(f"models: {n / 1e6:.1f} M parameters, bf16 on the GPU, built in "
            f"{time.perf_counter() - t0:.1f} s")
        if "unet" in phases:
            phase_unet(models, cpu_gen)
        if "edit" in phases:
            counts = phase_edit(models, args, cpu_gen)
        if "profile" in phases:
            phase_profile(models, cpu_gen)
    for e in entries:
        e["launches"] = None if counts is None else counts[e["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
