#!/usr/bin/env python3
"""GPU smoke run of the insv2v_torch port: builds the CUDA kernels from the
checkout, holds each against its plain PyTorch twin at the main paths'
shapes, checks a full-width UNet call and its gradients against the CPU
float32 run, drives the full-width dual-CFG video edit through
``VideoEditor`` (plain and motion-compensated by RAFT), trains the motion
modules at full width for a few steps, and runs the LOVEU-TGVE runner,
its scorer and the edit CLI.

    python3 chip_smoke.py                # every phase, one GPU
    python3 chip_smoke.py --only env,build,parity,grad,train,variants,flow,loveu

Phases: env, build, parity (kernels A, A', B, C, D against their twins,
with times, bounds and the one-call PyTorch yardstick), unet (GPU bf16 vs
CPU float32 on a small latent), edit (32 frames at 256x384, 3 windows,
50-step DDIM: the workload bench.py times for the JAX package), profile
(one UNet call of the edit under torch.profiler: device time by kernel
class and the device's idle share), variants (kernel A' and kernel D
switched on: one UNet call of the edit against the default kernels, then a
10-step edit window), grad (a full-width UNet forward and backward on the
GPU: the motion gradients against the CPU float32 run, and non-zero
gradients behind kernels A, B and C), train (full-width motion-module
training, 16 frames at 256x256, accumulation 2, remat and kernel A' on:
3 Adam steps and one Adam8bit step, one of them profiled), flow (the
32-frame edit with motion compensation through RAFT at full width, random
weights: flow and denoise seconds per window, and the card's RAFT against
the CPU's in float32), loveu (a one-video LOVEU-TGVE folder written
through cv2; ``run_loveu_tgve`` at its defaults, 384x384, 32 frames, DDPM
20, serially, resumed, and with ``--batch-edits 4``; ``score_loveu`` on its
GIFs with a random ViT-L/14; ``edit_video`` with Farneback flow).
It prints the card and its power limit, one JSON line of per-kernel
numbers, and last ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero with no result line. Weights are random from ``--seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel A: UNet attn1 at levels 0 and 1, then the VAE mid-block attention
# (encode chunks of 16 frames, decode chunks of 8) at 256x384, the
# training VAE encode (16 frames at 256x256), then the LOVEU runner's
# (384x384: UNet levels 0 and 1, VAE encode and decode)
FLASH_SHAPES = [(48, 8, 1536, 40), (48, 8, 384, 80), (16, 1, 1536, 512), (8, 1, 1536, 512),
                (16, 1, 1024, 512), (48, 8, 2304, 40), (48, 8, 576, 80), (16, 1, 2304, 512),
                (8, 1, 2304, 512)]
# kernel A': the edit's UNet attn1 shapes of kernel A (the VAE's one head
# takes A), then training's (16 frames at 256x256, where A' is on)
HEADFOLD_SHAPES = FLASH_SHAPES[:2] + [(16, 8, 1024, 40), (16, 8, 256, 80)]
# kernel B: (rows, C) of every spatial and motion FF at 48 frames of 32x48
# (the edit), at 16 frames of 32x32 (training), at 48 frames of 48x48 (LOVEU)
FF_SHAPES = [(73728, 320), (18432, 640), (4608, 1280), (1152, 1280),
             (16384, 320), (4096, 640), (1024, 1280), (256, 1280),
             (110592, 320), (27648, 640), (6912, 1280), (1728, 1280)]
# kernel C: (B, P, F, heads, e) of the motion modules at levels 0..3, the
# edit's (32x48 latents), then the LOVEU runner's (48x48)
TEMPORAL_SHAPES = [(3, 1536, 16, 8, 40), (3, 384, 16, 8, 80), (3, 96, 16, 8, 160),
                   (3, 24, 16, 8, 160), (3, 2304, 16, 8, 40), (3, 576, 16, 8, 80),
                   (3, 144, 16, 8, 160), (3, 36, 16, 8, 160)]
# kernel D: (rows, C) of the UNet's LayerNorms at 48 frames of 32x48 and
# of CLIP's (48 prompts of 77 tokens)
LN_SHAPES = [(73728, 320), (18432, 640), (4608, 1280), (48 * 77, 768)]
EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH = 32, 256, 384  # bench.py's workload
# training: micro-batch 1 of 16 frames at 256x256, accumulation 2
TRAIN_FRAMES, TRAIN_SIZE, TRAIN_ACCUM = 16, 256, 2
TOL = {  # max |kernel - f32 twin|, bf16-level: 8 mantissa bits of O(1) outputs
    "flash_attention": 2e-2, "flash_attention_headfold": 2e-2, "fused_geglu_ff": 6e-2,
    "temporal_attention": 2e-2, "fused_layer_norm": 2e-2}
# relative L2, GPU bf16 against CPU float32 through the full-width UNet:
# the forward, and the motion gradients of a forward and backward (both
# measured near 1e-2: bf16 rounding through ~50 layers each way)
UNET_TOL, GRAD_TOL = 5e-2, 5e-2
# relative L2 of the UNet output with kernels A' and D on against the
# default kernels, both bf16 at the edit shape: D and PyTorch's LayerNorm
# round their f32 results to bf16 apart, and the bf16 UNet carries any such
# difference to its own error level against f32 (each run within UNET_TOL
# of the CPU float32 output; the unet phase holds both to it)
VARIANT_TOL = UNET_TOL
# relative L2 of RAFT's flow on the card (float32, cuDNN's default TF32
# convolutions) against the CPU's float32 run on the same weights and pairs
RAFT_TOL = 5e-2
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "instruct_v2v.yaml")
# a video of the packaged edit-instruction dict, so the runner's default
# prompt source (the edit instructions) applies
LOVEU_VIDEO = "gold-fish"


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


def device_ms(fn, iters: int):
    """Device time per call and its clock: the CUDA activity (kernels,
    copies) in a torch.profiler trace of ``iters`` back-to-back calls,
    without the host gaps between launches that an event timing of a
    sub-0.1 ms kernel measures ("profiler"). Where three traces record no
    device time, the CUDA-event time per call, host gaps included
    ("events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then drops a short window's records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters, "profiler"
    log("device_ms: the profiler recorded no device time three times; CUDA events instead")
    return time_ms(fn, iters), "events"


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
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
            "launches": None, "launches_by_path": {},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "ms_source": head["ms_source"], "shapes": rows}


def _report(name, shape, err, kernel, plain, library, iters, bms, by):
    """Check one shape's error and time the kernel, its plain twin and the
    library call (None: there is none) on it: device time per call, with
    the clock each was read on (``ms_source``), and the kernel's CUDA-event
    time per back-to-back call beside it."""
    tol = TOL[name]
    if not (err <= tol):
        raise AssertionError(f"{name} {shape}: error {err} above {tol}")
    (ms, ms_clock), event_ms = device_ms(kernel, iters), time_ms(kernel, iters)
    plain_ms, plain_clock = device_ms(plain, max(1, iters // 4))
    lib_ms, lib_clock = (None, None) if library is None else device_ms(library, iters)
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"parity {name} {shape}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"kernel {ms:.4f} ms (events {event_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"library {lib} ms, bound {bms:.4f} ms ({by})")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "ms_source": {"ms": ms_clock, "plain_ms": plain_clock, "library_ms": lib_clock}}


def phase_parity(gen):
    import torch.nn.functional as F

    from insv2v_torch.ops.attention import (flash_attention, flash_attention_headfold,
                                            flash_attention_reference, flash_grid,
                                            temporal_attention, temporal_attention_reference)
    from insv2v_torch.ops.fused_ff import ff_grid, fused_geglu_ff, geglu_ff_reference
    from insv2v_torch.ops.fused_norm import fused_layer_norm, fused_layer_norm_reference

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
        bms, by = bound(4.0 * b * h * s * s * d, 2.0 * 4 * b * h * s * d)
        rows.append(_report("flash_attention", shape, err, lambda: flash_attention(q, k, v),
                            lambda: flash_attention_reference(q, k, v),
                            lambda: F.scaled_dot_product_attention(q, k, v), 10, bms, by))
        log(f"grid flash_attention {shape}: " + ", ".join(
            f"{key} {val}" for key, val in flash_grid(*shape, headfold=False).items()))
        del q, k, v, out, ref
    entries.append(_entry("flash_attention", "insv2v_torch/csrc/flash_attn.cu",
                          "insv2v_tpu/ops/attention.py:95", rows))

    rows = []
    for shape in HEADFOLD_SHAPES:
        b, h, s, d = shape
        q, k, v = (rnd(b, h, s, d) for _ in range(3))
        out = flash_attention_headfold(q, k, v)
        ref = flash_attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        bms, by = bound(4.0 * b * h * s * s * d, 2.0 * 4 * b * h * s * d)
        rows.append(_report("flash_attention_headfold", shape, err,
                            lambda: flash_attention_headfold(q, k, v),
                            lambda: flash_attention_reference(q, k, v),
                            lambda: F.scaled_dot_product_attention(q, k, v), 10, bms, by))
        log(f"grid flash_attention_headfold {shape}: " + ", ".join(
            f"{key} {val}" for key, val in flash_grid(*shape, headfold=True).items()))
        del q, k, v, out, ref
    entries.append(_entry("flash_attention_headfold", "insv2v_torch/csrc/flash_attn.cu",
                          "insv2v_tpu/ops/attention.py:131", rows))

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
        bms, by = bound(6.0 * n * c * inner,
                        2.0 * (2 * n * c + 3 * c * inner + 2 * inner + 3 * c))
        rows.append(_report("fused_geglu_ff", (n, c), err, lambda: fused_geglu_ff(*args),
                            lambda: geglu_ff_reference(*args), None, 10, bms, by))
        # what cuBLAS gives the two bare products at this shape: a yardstick
        # of the card, not library_ms (no one call computes B's function)
        xn, hid = rnd(n, c), rnd(n, inner)
        gemm1_ms, _ = device_ms(lambda: F.linear(xn, w1), 10)
        gemm2_ms, _ = device_ms(lambda: F.linear(hid, w2), 10)
        rows[-1]["cublas_ms"] = {"gemm1": gemm1_ms, "gemm2": gemm2_ms}
        log(f"cublas fused_geglu_ff {(n, c)}: F.linear GEMM1 {gemm1_ms:.4f} ms + GEMM2 "
            f"{gemm2_ms:.4f} ms = {gemm1_ms + gemm2_ms:.4f} ms")
        log(f"grid fused_geglu_ff {(n, c)}: " + ", ".join(
            f"{key} {val}" for key, val in ff_grid(n, c, inner).items()))
        del x, w1, w2, args, out, ref, xn, hid
    entries.append(_entry("fused_geglu_ff", "insv2v_torch/csrc/geglu_ff.cu",
                          "insv2v_tpu/ops/fused_ff.py:155", rows))

    rows = []
    for shape in TEMPORAL_SHAPES:
        b, p, f, h, e = shape
        q, k, v = (rnd(*shape) for _ in range(3))
        out = temporal_attention(q, k, v)
        ref = temporal_attention_reference(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        sd = lambda t: t.permute(0, 1, 3, 2, 4).reshape(b * p * h, 1, f, e)
        qs, ks, vs = sd(q), sd(k), sd(v)
        bms, by = bound(4.0 * b * p * h * f * f * e, 2.0 * 4 * b * p * f * h * e)
        rows.append(_report("temporal_attention", shape, err, lambda: temporal_attention(q, k, v),
                            lambda: temporal_attention_reference(q, k, v),
                            lambda: F.scaled_dot_product_attention(qs, ks, vs), 20, bms, by))
    entries.append(_entry("temporal_attention", "insv2v_torch/csrc/temporal_attn.cu",
                          "insv2v_tpu/ops/attention.py:345", rows))

    rows = []
    for n, c in LN_SHAPES:
        x = (rnd(n, c).float() * 2 + 0.5).to(torch.bfloat16)
        # the f32 affine the kernel reads, as the wrapper hands it over
        lw, lb = 1.0 + 0.1 * rnd(c).float(), 0.1 * rnd(c).float()
        out = fused_layer_norm(x, lw, lb)
        ref = fused_layer_norm_reference(x.float(), lw, lb)
        err = (out.float() - ref).abs().max().item()
        lw16, lb16 = lw.to(torch.bfloat16), lb.to(torch.bfloat16)
        bms, by = bound(8.0 * n * c, 2.0 * 2 * n * c + 2 * 4 * c, PEAK_F32_FLOPS)
        rows.append(_report("fused_layer_norm", (n, c), err, lambda: fused_layer_norm(x, lw, lb),
                            lambda: fused_layer_norm_reference(x, lw, lb),
                            lambda: F.layer_norm(x, (c,), lw16, lb16), 20, bms, by))
    entries.append(_entry("fused_layer_norm", "insv2v_torch/csrc/layer_norm.cu",
                          "insv2v_tpu/ops/fused_norm.py:22", rows))
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
    same bf16-rounded weights in float32 on the CPU through the twins; then
    the same call with kernels A' and D switched on."""
    import copy

    unet = models["unet"]
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    x = torch.randn(1, 2, 32, 32, 8, generator=gen)
    ctx = torch.randn(1, 77, 768, generator=gen)
    t = torch.tensor([501])
    with torch.no_grad():
        ref = cpu(x, t, ctx, video_start_index=4)
    del cpu
    for label, switched in (("default kernels", False), ("kernels A' and D", True)):
        with torch.no_grad(), _switches(switched, switched):
            _zero_launches()
            got = unet(x.cuda(), t.cuda(), ctx.cuda(), video_start_index=4).float().cpu()
            if switched:
                _read_launches("small-latent UNet call",
                               ("flash_attention_headfold", "fused_layer_norm"))
        rel = ((got - ref).norm() / ref.norm()).item()
        log(f"unet full width, 2x32x32 latent, {label}: rel L2 err GPU bf16 vs CPU f32 "
            f"{rel:.3e} (tol {UNET_TOL:g}), max |ref| {ref.abs().max().item():.3f}")
        if not (torch.isfinite(got).all() and rel <= UNET_TOL):
            raise AssertionError(f"UNet GPU/CPU disagreement with {label}: {rel}")


def phase_edit(models, args, gen):
    from insv2v_torch import VideoEditor
    from insv2v_torch.text.tokenizer import HashTokenizer

    editor = VideoEditor(models["unet"], models["vae"], models["text_model"],
                         tokenizer=HashTokenizer(), scheduler="ddim",
                         num_steps=args.steps, device="cuda")
    f, hgt, wid = EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH
    frames = _edit_frames(gen)
    from insv2v_torch.diffusion.samplers import split_windows

    windows = split_windows(f, 16, 4)
    log(f"edit: {f} frames {hgt}x{wid}, DDIM {args.steps} steps, "
        f"{len(windows)} windows, dual CFG (3x batch = {3 * 16} frames per UNet call)")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    out = editor(frames, "make it snowy", frames_per_window=16, num_ref_frames=4,
                 seed=args.seed, timings=timings)
    wall = time.perf_counter() - t0
    counts = _read_launches("edit", ("flash_attention", "fused_geglu_ff", "temporal_attention"))
    log("edit stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f"; total {wall:.3f}")
    win = [v for k, v in timings.items() if k.startswith("window_")]
    per_step = sum(win) / (len(win) * args.steps)
    log(f"edit per window {sum(win) / len(win):.3f} s, per UNet step "
        f"{per_step:.4f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    calls = len(windows) * args.steps
    vae_chunks = math.ceil(f / 16) + math.ceil(f / 8)
    log(f"launches in the edit: {counts}; per UNet call: flash "
        f"{(counts['flash_attention'] - vae_chunks) / calls:g} (+{vae_chunks} VAE), "
        f"ff {counts['fused_geglu_ff'] / calls:g}, "
        f"temporal {counts['temporal_attention'] / calls:g}")
    if out.shape != (f, hgt, wid, 3) or not np_finite(out):
        raise AssertionError(f"edit output shape {out.shape} or non-finite values")
    log(f"edit output: shape {out.shape}, range [{out.min():.3f}, {out.max():.3f}], "
        f"std {out.std():.4f}")
    return counts, per_step


def _edit_frames(gen, f=EDIT_FRAMES, hgt=EDIT_HEIGHT, wid=EDIT_WIDTH):
    """A smooth moving pattern in [-1, 1] (F, H, W, 3), from the seed."""
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, hgt), torch.linspace(-1, 1, wid),
                            indexing="ij")
    phase = torch.rand(3, generator=gen) * 6.28
    tt = torch.arange(f).float()[:, None, None, None] * 0.1
    frames = torch.sin(3 * xx[None, ..., None] + 2 * yy[None, ..., None] + tt + phase)
    return (0.8 * frames).float().numpy()


def phase_flow(models, args, gen, plain_step):
    """The edit phase's 32-frame 256x384 DDIM edit with motion compensation:
    RaftFlow at the full RaftConfig (random weights from the seed) on the
    card, each window's flows (4 refs x 12 queries, then 12 x 4) apart from
    its denoise; then the card's RAFT, float32 with cuDNN's default TF32
    convolutions and with TF32 off, against the CPU's float32 run on two of
    the edit's frame pairs."""
    import copy

    from insv2v_torch import VideoEditor
    from insv2v_torch.diffusion.samplers import split_windows
    from insv2v_torch.models.raft import RaftConfig
    from insv2v_torch.text.tokenizer import HashTokenizer
    from insv2v_torch.utils.flow import RaftFlow

    est = RaftFlow(allow_random=True, cfg=RaftConfig(), device="cuda", seed=args.seed)
    editor = VideoEditor(models["unet"], models["vae"], models["text_model"],
                         tokenizer=HashTokenizer(), scheduler="ddim", num_steps=args.steps,
                         device="cuda")
    frames = _edit_frames(gen)
    windows = split_windows(EDIT_FRAMES, 16, 4)
    pairs = [(w.num_frames - w.num_ref) * w.num_ref for w in windows[1:]]
    log(f"flow: {EDIT_FRAMES} frames {EDIT_HEIGHT}x{EDIT_WIDTH}, DDIM {args.steps} steps, RAFT "
        f"full config, TF32 convolutions {torch.backends.cudnn.allow_tf32}, (query, ref) "
        f"pairs per follow-up window {pairs}")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    out = editor(frames, "make it snowy", frames_per_window=16, num_ref_frames=4,
                 seed=args.seed, timings=timings, use_motion_compensation=True,
                 flow_estimator=est)
    wall = time.perf_counter() - t0
    counts = _read_launches("flow", ("flash_attention", "fused_geglu_ff", "temporal_attention"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("flow stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f"; total {wall:.3f}")
    win = [v for k, v in timings.items() if k.startswith("window_")]
    step = sum(win) / (len(win) * args.steps)
    for k, n in enumerate(pairs, start=1):
        log(f"flow window {k}: {n} pairs, flows {timings[f'flows_{k}']:.3f} s "
            f"({timings[f'flows_{k}'] / n * 1e3:.2f} ms per pair), denoise "
            f"{timings[f'window_{k}']:.3f} s")
    log(f"flow per UNet step {step:.4f} s (plain edit {plain_step if plain_step else 'not run'}); "
        f"peak memory {peak:.2f} GiB")
    if out.shape != (EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH, 3) or not np_finite(out):
        raise AssertionError(f"flow edit output shape {out.shape} or non-finite values")

    qs, rs = frames[[8, 20]], frames[[2, 14]]
    cpu = copy.deepcopy(est.model).cpu()
    with torch.no_grad():
        ref = cpu(torch.from_numpy(qs), torch.from_numpy(rs))
    del cpu
    tf32 = torch.backends.cudnn.allow_tf32
    errs = {}
    for allow in (True, False):
        torch.backends.cudnn.allow_tf32 = allow
        got = est.batch(qs, rs).cpu()
        errs[allow] = ((got - ref).norm() / ref.norm()).item()
        epe = (got - ref).norm(dim=-1)
        log(f"flow RAFT card vs CPU f32, 2 pairs {EDIT_HEIGHT}x{EDIT_WIDTH}, TF32 {allow}: "
            f"rel L2 {errs[allow]:.3e} (tol {RAFT_TOL:g}), end-point error mean "
            f"{epe.mean().item():.4e} px, max {epe.max().item():.4e} px; |flow| mean "
            f"{ref.norm(dim=-1).mean().item():.3f} px")
    # one window's 48 pairs (window 1: 12 queries x 4 refs), timed with
    # TF32 on and off, then profiled with the default
    q48 = frames[[q for q in range(4, 16) for _ in range(4)]]
    r48 = frames[[r for _ in range(4, 16) for r in range(4)]]
    for allow in (True, False):
        torch.backends.cudnn.allow_tf32 = allow
        ms = time_ms(lambda: est.batch(q48, r48), 3, warmup=1)
        log(f"flow RAFT, 48 pairs (3 calls of 16), TF32 {allow}: {ms:.2f} ms, "
            f"{ms / 48:.3f} ms per pair (events)")
    torch.backends.cudnn.allow_tf32 = tf32
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.batch(q48, r48)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"flow RAFT profile, 48 pairs: {wall_ms:.2f} ms wall with the profiler, device busy "
        f"{busy_ms:.2f} ms, {sum(e.count for e in kernels)} kernels; by class: "
        f"{_by_class(kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"flow RAFT profile:   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d} calls  "
            f"{e.key[:100]}")
    if not (torch.isfinite(ref).all() and errs[tf32] <= RAFT_TOL):
        raise AssertionError(f"RAFT on the card disagrees with the CPU: {errs}")
    return counts


def _write_loveu(root, gen, frames=60, hgt=480, wid=854):
    """A LOVEU-TGVE folder: one DAVIS video (a moving pattern from the seed,
    mp4v at 24 fps through cv2) and the CSV with its header and section
    row. Returns the video's path."""
    import cv2
    import numpy as np

    folder = os.path.join(root, "DAVIS_480p", "480p_videos")
    os.makedirs(folder)
    path = os.path.join(folder, f"{LOVEU_VIDEO}.mp4")
    video = (_edit_frames(gen, frames, hgt, wid) * 127.5 + 127.5).round().astype(np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (wid, hgt))
    for fr in video:
        vw.write(fr[..., ::-1].copy())
    vw.release()
    with open(os.path.join(root, "LOVEU-TGVE-2023_Dataset.csv"), "w") as f:
        f.write("Video name,Original,Style,Object,Background,Multiple\n")
        f.write("DAVIS Videos:,,,,,\n")
        f.write(f"{LOVEU_VIDEO},goldfish swimming,goldfish in ink,sharks swimming,"
                "goldfish in a pond,sharks in a pond\n")
    return path


def phase_loveu(gen):
    """The LOVEU-TGVE runner at its defaults (384x384, 32 frames, DDPM 20,
    text CFG 7.5, video CFG 1.8, the packaged edit instructions), full
    width with random weights, over a one-video folder: 4 edits in serial
    chains (timed, launches counted), a resumed run that does no work, and
    the 4 edits as one chain (``--batch-edits 4``); then the scorer on the
    serial run's GIFs (ViT-L/14, random weights) and the edit CLI with
    Farneback flow at 16 frames in windows of 12 (8 refs)."""
    import tempfile

    from insv2v_torch.apps import edit_video, run_loveu_tgve, score_loveu
    from insv2v_torch.utils.media import load_gif

    with tempfile.TemporaryDirectory() as tmp:
        video = _write_loveu(tmp, gen)
        argv = ["--config-path", CONFIG, "--data-dir", tmp, "--allow-random-weights",
                "--limit-videos", "1"]
        out, out_b = os.path.join(tmp, "out"), os.path.join(tmp, "out_batched")
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        serial = run_loveu_tgve.main(argv + ["--output-dir", out])
        wall = time.perf_counter() - t0
        counts = _read_launches("loveu", ("flash_attention", "fused_geglu_ff",
                                          "temporal_attention"))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gifs = sorted(f for f in os.listdir(out) if f.endswith(".gif"))
        used = json.load(open(os.path.join(out, "prompts_used.json")))
        saved = json.load(open(os.path.join(out, "throughput.json")))
        log(f"loveu serial: {serial['videos']} edits, {serial['frames']} frames in "
            f"{serial['seconds']:.3f} s of editing, {serial['output_seconds']:.3f} s writing "
            f"GIFs and frames ({wall:.3f} s with model build and video read): "
            f"{serial['frames_per_sec']:.4f} frames/s; peak memory {peak:.2f} GiB")
        log("loveu serial stages summed (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in serial["stage_seconds"].items()))
        steps = 20 * 3 * serial["videos"]
        win = sum(v for k, v in serial["stage_seconds"].items() if k.startswith("window_"))
        log(f"loveu per UNet step {win / steps:.4f} s; prompts: {sorted(set(used.values()))}")
        gif = load_gif(os.path.join(out, gifs[0]))
        if (len(gifs) != 4 or saved["videos"] != 4 or len(used) != 4
                or gif.shape != (32, 384, 768, 3) or not np_finite(gif)):
            raise AssertionError(f"loveu outputs: {gifs}, {saved}, {used}, {gif.shape}")
        again = run_loveu_tgve.main(argv + ["--output-dir", out])
        if again["videos"] != 0:
            raise AssertionError(f"loveu resume did work: {again}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batched = run_loveu_tgve.main(argv + ["--output-dir", out_b, "--batch-edits", "4"])
        wall_b = time.perf_counter() - t0
        log(f"loveu --batch-edits 4: {batched['frames']} frames in {batched['seconds']:.3f} s, "
            f"{batched['output_seconds']:.3f} s writing GIFs and frames ({wall_b:.3f} s with "
            f"model build and video read): {batched['frames_per_sec']:.4f} "
            f"frames/s (serial {serial['frames_per_sec']:.4f}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; stages summed (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in batched["stage_seconds"].items()))
        if len([f for f in os.listdir(out_b) if f.endswith(".gif")]) != 4:
            raise AssertionError("loveu --batch-edits 4 did not write 4 GIFs")

        t0 = time.perf_counter()
        scores = score_loveu.main(["--outputs", out, "--data-dir", tmp,
                                   "--allow-random-weights"])
        log(f"loveu scores ({time.perf_counter() - t0:.3f} s, ViT-L/14 random weights): "
            + ", ".join(f"{k} {scores[k]:.4f}" for k in
                        ("sim_0", "sim_1", "sim_direction", "sim_image")))
        if scores["count"] != 4 or not all(math.isfinite(scores[k]) for k in
                                           ("sim_0", "sim_1", "sim_direction", "sim_image")):
            raise AssertionError(f"loveu scores: {scores}")

        gif_path = os.path.join(tmp, "edited.gif")
        t0 = time.perf_counter()
        edit_video.main(["--video", video, "--prompt", "make it snowy", "--output", gif_path,
                         "--config", CONFIG, "--allow-random-weights", "--num-frames", "16",
                         "--frames-in-batch", "12", "--with-optical-flow",
                         "--flow-estimator", "farneback"])
        edited = load_gif(gif_path)
        log(f"edit_video CLI, 16 frames 384x384, Farneback flow: {time.perf_counter() - t0:.3f} s "
            f"with model build and I/O; GIF {edited.shape}")
        if edited.shape != (16, 384, 768, 3) or not np_finite(edited):
            raise AssertionError(f"edit_video output {edited.shape}")
    return counts


def _kernel_fns():
    """Every kernel wrapper, by name; each counts its own launches."""
    from insv2v_torch.ops.attention import (flash_attention, flash_attention_headfold,
                                            temporal_attention)
    from insv2v_torch.ops.fused_ff import fused_geglu_ff
    from insv2v_torch.ops.fused_norm import fused_layer_norm

    fns = (flash_attention, flash_attention_headfold, fused_geglu_ff, temporal_attention,
           fused_layer_norm)
    return {f.__name__: f for f in fns}


def _zero_launches():
    for f in _kernel_fns().values():
        f.launches = 0


def _read_launches(path, must):
    """The launch counts since _zero_launches; fails if a kernel of the
    path (``must``) was never launched."""
    counts = {name: f.launches for name, f in _kernel_fns().items()}
    log(f"launches on the {path} path: {counts}")
    missing = [k for k in must if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")
    return counts


@contextlib.contextmanager
def _switches(headfold: bool, fused_ln: bool):
    """Kernel A' (``FLASH_HEADFOLD``) and kernel D (``FUSED_LAYER_NORM``)
    as the defaults of the port's dispatchers, for a ``with`` block."""
    from insv2v_torch.ops import attention, norms

    saved = attention.FLASH_HEADFOLD, norms.FUSED_LAYER_NORM
    attention.FLASH_HEADFOLD, norms.FUSED_LAYER_NORM = headfold, fused_ln
    try:
        yield
    finally:
        attention.FLASH_HEADFOLD, norms.FUSED_LAYER_NORM = saved


def phase_variants(models, gen):
    """Kernels A' and D switched on (the JAX package's INSV2V_FLASH_HEADFOLD
    and INSV2V_PALLAS_NORM): one UNet call at the edit shape (3 x 16 frames
    of 32x48) against the default kernels, then one 16-frame window of the
    edit at 10 DDIM steps, which must launch both."""
    from insv2v_torch import VideoEditor
    from insv2v_torch.text.tokenizer import HashTokenizer

    unet = models["unet"]
    x = torch.randn(3, 16, 32, 48, 8, generator=gen).cuda().bfloat16()
    ctx = torch.randn(3, 77, 768, generator=gen).cuda().bfloat16()
    t = torch.full((3,), 501, device="cuda")
    with torch.no_grad():
        base = unet(x, t, ctx, video_start_index=0).float()
        with _switches(True, True):
            _zero_launches()
            var = unet(x, t, ctx, video_start_index=0).float()
            counts = _read_launches("variant UNet call",
                                    ("flash_attention_headfold", "fused_layer_norm"))
    rel = ((var - base).norm() / base.norm()).item()
    log(f"variants: one UNet call with kernels A' and D on vs the defaults: rel L2 {rel:.3e} "
        f"(tol {VARIANT_TOL:g}); A' {counts['flash_attention_headfold']} launches, "
        f"D {counts['fused_layer_norm']}")
    if not (torch.isfinite(var).all() and rel <= VARIANT_TOL):
        raise AssertionError(f"variant UNet call disagrees with the defaults: {rel}")

    editor = VideoEditor(unet, models["vae"], models["text_model"], tokenizer=HashTokenizer(),
                         scheduler="ddim", num_steps=10, device="cuda")
    frames = (torch.rand(16, EDIT_HEIGHT, EDIT_WIDTH, 3, generator=gen) * 1.6 - 0.8).numpy()
    timings = {}
    with _switches(True, True):
        _zero_launches()
        out = editor(frames, "make it snowy", frames_per_window=16, num_ref_frames=4,
                     seed=0, timings=timings)
        counts = _read_launches("variant edit",
                                ("flash_attention_headfold", "fused_layer_norm",
                                 "fused_geglu_ff", "temporal_attention"))
    if out.shape != (16, EDIT_HEIGHT, EDIT_WIDTH, 3) or not np_finite(out):
        raise AssertionError(f"variant edit output shape {out.shape} or non-finite values")
    log("variants: 16-frame edit window, 10 DDIM steps, A' and D on: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
    return counts


def np_finite(a) -> bool:
    return bool(torch.isfinite(torch.from_numpy(a)).all())


# the gradients the grad phase requires non-zero on the card: q/k/v of a
# motion attention (kernel C) and of a spatial self-attention at S = 1024
# (kernel A), the motion and spatial FF weights (kernel B)
_GRAD_CHECKS = tuple(
    [f"down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
     f"attention_blocks.0.{w}.weight" for w in ("to_q", "to_k", "to_v")]
    + [f"down_blocks.0.attentions.0.transformer_blocks.0.attn1.{w}.weight"
       for w in ("to_q", "to_k", "to_v")]
    + ["down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
       "ff.net.0.proj.weight", "down_blocks.0.motion_modules.0.temporal_transformer."
       "transformer_blocks.0.ff.net.2.weight",
       "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"])


def _unet_grads(unet, x, t, ctx, target, names):
    """Gradients of the l2 loss against ``target`` for the named
    parameters (and no others), in float32 on the CPU."""
    params = dict(unet.named_parameters())
    unet.requires_grad_(False)
    for n in names:
        params[n].requires_grad_(True)
    pred = unet(x, t, ctx, video_start_index=4)
    loss = (pred.float() - target.to(pred.device)).square().mean()
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    unet.requires_grad_(False)
    return loss.item(), [g.float().cpu() for g in grads]


def phase_grad(models, gen):
    """A full-width UNet forward and backward on a small latent (2 frames of
    32x32: the S = 1024 and 256 levels take kernel A) on the GPU in bf16,
    against the same bf16-rounded weights in float32 on the CPU through the
    twins: the motion parameters' gradients as one vector, relative L2; and
    non-zero gradients behind kernels A, B and C on the card."""
    import copy

    from insv2v_torch.training.trainer import motion_param_mask

    unet = models["unet"]
    mask = motion_param_mask(dict(unet.named_parameters()))
    names = [n for n, m in mask.items() if m] + [n for n in _GRAD_CHECKS if not mask[n]]
    x = torch.randn(1, 2, 32, 32, 8, generator=gen)
    ctx = torch.randn(1, 77, 768, generator=gen)
    target = torch.randn(1, 2, 32, 32, 4, generator=gen)
    t = torch.tensor([501])
    t0 = time.perf_counter()
    loss_gpu, g_gpu = _unet_grads(unet, x.cuda(), t.cuda(), ctx.cuda(), target, names)
    t_gpu = time.perf_counter() - t0
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _unet_grads(cpu, x, t, ctx, target, names)
    t_cpu = time.perf_counter() - t0
    del cpu
    n_motion = sum(mask.values())
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs[:n_motion]])
    ref = flat(g_cpu)
    rel = ((flat(g_gpu) - ref).norm() / ref.norm()).item()
    per = sorted(((((a - b).norm() / b.norm()).item(), n) for a, b, n in
                  zip(g_gpu[:n_motion], g_cpu[:n_motion], names) if b.norm() > 0),
                 reverse=True)
    log(f"grad: full-width UNet fwd+bwd, 1x2x32x32 latent: loss GPU {loss_gpu:.6f} CPU "
        f"{loss_cpu:.6f}; motion grads ({n_motion} tensors, {ref.numel() / 1e6:.1f} M values) "
        f"rel L2 GPU bf16 vs CPU f32 {rel:.3e} (tol {GRAD_TOL:g}); worst tensor "
        f"{per[0][0]:.3e} ({per[0][1]}); GPU {t_gpu:.2f} s, CPU {t_cpu:.1f} s")
    gpu = dict(zip(names, g_gpu))
    for n in _GRAD_CHECKS:
        norm = gpu[n].norm().item()
        log(f"grad:   |grad| {norm:.4e}  {n}")
        if not (math.isfinite(norm) and norm > 0):
            raise AssertionError(f"no gradient reaches {n} on the card")
    if not (math.isfinite(rel) and rel <= GRAD_TOL):
        raise AssertionError(f"motion gradients disagree GPU vs CPU: {rel}")


def _leaf_row(params, motion: bool):
    """(name, first 8 values of the first row) of the first 2-D tensor of
    ``params`` (name -> tensor) that is (or is not) a motion parameter."""
    for name, p in params.items():
        if ("motion_modules." in name) == motion and p.ndim >= 2:
            return name, p.detach()[(0,) * (p.ndim - 1)][:8].float().cpu().clone()
    raise AssertionError("no such parameter")


def phase_train(models, args, gen):
    """Full-width motion-module training (configs/instruct_v2v.yaml): micro-
    batch 1 of 16 frames at 256x256, accumulation 2, remat on, kernel A' on
    (as INSV2V_FLASH_HEADFOLD=1 runs the JAX trainer), synthetic uniform
    videos made on the device. 3 Adam steps (the first warms up, one of the
    others is profiled) and one Adam8bit step; the loss, seconds per
    microbatch, peak memory, a motion-only update and the forward launches
    of A, A', B and C."""
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from insv2v_torch.text.tokenizer import HashTokenizer
    from insv2v_torch.training.trainer import TrainConfig, Trainer

    unet, vae, text = models["unet"], models["vae"], models["text_model"]
    unet.cfg = dataclasses.replace(unet.cfg, remat=True)
    shape = (TRAIN_ACCUM, TRAIN_FRAMES, TRAIN_SIZE, TRAIN_SIZE, 3)  # micro-batch 1
    ids = np.asarray(HashTokenizer()(["make it snowy", "turn the dog into a cat"]))
    batches = [{"input_video": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
                "edited_video": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
                "prompt_ids": ids} for _ in range(3)]
    # the motion-only check of bench_train.py: one frozen leaf of the model
    # unchanged, one motion leaf of the float32 masters moved (at lr 1e-5
    # most of an update is below the bf16 copy's resolution)
    frozen_name, frozen_before = _leaf_row(dict(unet.named_parameters()), False)
    moved, losses = {}, []
    with _switches(True, False):
        for kind, steps in (("adam", 3), ("adam8bit", 1)):
            trainer = Trainer(unet, vae, text, TrainConfig(
                lr=1e-5, optimizer=kind, accumulate_grad_batches=TRAIN_ACCUM))
            state = trainer.create_state()
            motion_name, motion_before = _leaf_row(state.params, True)
            tgen = torch.Generator(device="cuda").manual_seed(args.seed)
            for i in range(steps):
                # Adam step 1 warms up, step 2 is timed and counted, step 3
                # runs under the profiler
                timed, profiled = kind == "adam" and i == 1, kind == "adam" and i == 2
                if timed:
                    torch.cuda.reset_peak_memory_stats()
                    _zero_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                      if profiled else contextlib.nullcontext()) as prof_ctx:
                    _, m = trainer.train_step(state, batches[i], tgen)
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                losses.append(m["train_loss"])
                log(f"train: {kind} step {state.step}: loss {m['train_loss']:.6f}, "
                    f"{dt:.3f} s ({dt / TRAIN_ACCUM:.3f} s per microbatch"
                    f"{', profiled' if profiled else ''})")
                if timed:
                    step2_s, peak = dt, torch.cuda.max_memory_allocated() / 2 ** 30
                    counts = _read_launches(
                        "train", ("flash_attention", "flash_attention_headfold",
                                  "fused_geglu_ff", "temporal_attention"))
                if profiled:
                    prof, prof_wall = prof_ctx, dt
            moved[kind] = not torch.equal(motion_before, _leaf_row(state.params, True)[1])
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    motion_only = (torch.equal(frozen_before, _leaf_row(dict(unet.named_parameters()),
                                                         False)[1]) and all(moved.values()))
    log(f"train: full width, {TRAIN_FRAMES}f@{TRAIN_SIZE}x{TRAIN_SIZE}, micro-batch 1, "
        f"accum {TRAIN_ACCUM}, remat, kernel A' on: {step2_s / TRAIN_ACCUM:.4f} s per "
        f"microbatch (Adam step 2), peak memory {peak:.2f} GiB; per microbatch launches "
        + ", ".join(f"{k} {v / TRAIN_ACCUM:g}" for k, v in counts.items()))
    log(f"train: profiled Adam step: {prof_wall:.3f} s wall, device busy {busy_s:.3f} s "
        f"(idle share {max(0.0, 1 - busy_s / prof_wall):.3f} with the profiler's host cost; "
        f"{max(0.0, 1 - busy_s / step2_s):.3f} of the unprofiled step 2's "
        f"{step2_s:.3f} s); device time by class: {_by_class(kernels)}")
    for e in host:
        log(f"train:   host {e.self_cpu_time_total / 1e3:9.1f} ms self  {e.count:6d} calls  "
            f"{e.key[:90]}")
    log(f"train: motion-only update: {motion_only} (frozen {frozen_name} unchanged; "
        f"motion master {motion_name} moved: {moved})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not motion_only:
        raise AssertionError("the update was not motion-only")
    return counts


PROFILE_CLASSES = (  # kernel-name fragments, matched in this order
    ("kernel A (flash)", ("flash_fwd",)), ("kernel B (ff)", ("ff_gate", "ff_out")),
    ("kernel C (temporal)", ("temporal_attn",)),
    ("convolution", ("conv", "fprop", "implicit", "winograd")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def _by_class(kernels) -> str:
    """Device time of profiler kernel events summed by PROFILE_CLASSES."""
    by_class = {}
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c, frags in PROFILE_CLASSES if any(f in name for f in frags)),
                   "other (norms, elementwise, copies)")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    return ", ".join(f"{c} {ms:.2f} ms" for c, ms in sorted(by_class.items(),
                                                             key=lambda kv: -kv[1]))


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
    log(f"profile: one UNet call {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}); by class: {_by_class(kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d} calls  "
            f"{e.key[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="env,build,parity,unet,edit,flow,profile,variants,grad,"
                                      "train,loveu")
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
    entries, paths = [], {}
    if "build" in phases:
        phase_build()
    if "parity" in phases:
        entries = phase_parity(gen)
    if {"unet", "edit", "flow", "profile", "variants", "grad", "train"} & set(phases):
        from insv2v_torch.utils.factory import build_models

        t0 = time.perf_counter()
        models = build_models(device="cuda", dtype=torch.bfloat16, seed=args.seed)
        _wake_motion_modules(models["unet"], cpu_gen)
        n = sum(p.numel() for m in models.values() for p in m.parameters())
        log(f"models: {n / 1e6:.1f} M parameters, bf16 on the GPU, built in "
            f"{time.perf_counter() - t0:.1f} s")
        if "unet" in phases:
            phase_unet(models, cpu_gen)
        plain_step = None
        if "edit" in phases:
            paths["edit"], plain_step = phase_edit(models, args, cpu_gen)
        if "flow" in phases:
            paths["flow"] = phase_flow(models, args, cpu_gen, plain_step)
        if "profile" in phases:
            phase_profile(models, cpu_gen)
        if "variants" in phases:
            paths["variants"] = phase_variants(models, cpu_gen)
        if "grad" in phases:
            phase_grad(models, cpu_gen)
        if "train" in phases:  # last of these: it trains the motion weights
            paths["train"] = phase_train(models, args, gen)
        del models
    if "loveu" in phases:  # the runner builds its own models
        paths["loveu"] = phase_loveu(cpu_gen)
    # each kernel's launches on the path it belongs to: A, B, C the edit's
    # (their first slice), A' training's, D the variant edit window's
    home = {"flash_attention": "edit", "fused_geglu_ff": "edit", "temporal_attention": "edit",
            "flash_attention_headfold": "train", "fused_layer_norm": "variants"}
    for e in entries:
        e["launches_by_path"] = {p: c[e["name"]] for p, c in paths.items()}
        e["launches"] = e["launches_by_path"].get(home[e["name"]])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
