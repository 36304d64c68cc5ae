#!/usr/bin/env python3
"""GPU smoke run of the insv2v_torch port: builds the CUDA kernels from the
checkout, holds each against its plain PyTorch twin at the main paths'
shapes, checks a full-width UNet call and its gradients against the CPU
float32 run, drives the full-width dual-CFG video edit through
``VideoEditor`` (plain and motion-compensated by RAFT), trains the motion
modules at full width for a few steps, and runs the LOVEU-TGVE runner,
its scorer and the edit CLI, and generates synthetic prompt-to-prompt
pairs with the full-width ModelScope UNet; then rehearses the multi-process
paths with two ranks sharing the card over gloo (data-parallel training,
frame- and batch-sharded windows) and times the native batch loader.

    python3 chip_smoke.py                # every phase, one GPU
    python3 chip_smoke.py --only env,build,parity,grad,train,variants,flow,loveu,datagen
    python3 chip_smoke.py --only env,build,dp,sp,loader
    python3 chip_smoke.py --only env,build,split,demo,t5
    python3 chip_smoke.py --only env,build,parity,ckpt

Phases: env, build, parity (kernels A, A', B, C, D, E against their twins,
with times, bounds and the one-call PyTorch yardstick), unet (GPU bf16 vs
CPU float32 on a small latent), ckpt (the UNet written as a Lightning
checkpoint with pickled hyper-parameters and loaded through the edit
CLI's ``make_editor``: every tensor bit-equal, one edit UNet call against
the source UNet, and a planted dropped tensor that must read above the
gate), edit (32 frames at 256x384, 3 windows,
50-step DDIM: the workload bench.py times for the JAX package), profile
(one UNet call of the edit under torch.profiler: device time by kernel
class and the device's idle share), split (the up blocks' split-skip path,
the edit's default, against the concat path on one UNet call of the edit,
and against the CPU's float32 call; both calls profiled: busy time, copies,
norms, convolution, idle share), variants (kernel A' and kernel D
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
GIFs with a random ViT-L/14; ``edit_video`` with Farneback flow), demo
(the web demo at its defaults, 384x384, 32 frames, DDPM 20, served on a
local port: the form, two edits of a 40-frame mp4, motion compensation off
and on, answered as GIFs, kernel A, B and C launches, a 413), t5 (T5
v1.1-large on the card against the CPU's float32 run, ms per encode, and
``ClipT5Encoder`` with the ViT-L/14 text tower), datagen (the full-width ModelScope UNetSD, GPU bf16 vs CPU float32 with
a plain, a (key, value) and an ``sa_share`` context; ``generate_dataset``
at its defaults, v2 with the CLIP filter over random ViT-L/14 weights and
v1 without it: seconds per pair and per UNetSD call, kernel A's launches),
loader (the three native batch ops at the training size against their
numpy twins, then the train phase's step with batches assembled by the
native crop op, with the prefetch loader on and off), dp (one microbatch
with the models stored in float32 under bf16 autocast against
bf16-stored ones; ``apps/train.py`` as two processes with
``--frozen-f32``: rank 0 alone writes; then two ranks spawned on the card
over gloo, the train phase's setup: one Adam and one Adam8bit step of the
data-parallel trainer on a global batch of 4 against a one-process step
on the same batch and draws, the optimizer state's bytes per rank), sp
(two ranks, frames sharded: an edit-shaped 16-frame 256x384 window and a
follow-up window against the unsharded ones, kernel C's launches by shape
and the all-to-all bytes; one UNet call against the unsharded one; each
again with a fault planted in the exchange, which must read above the
gate; then a 2-video window sharded by videos). The dp and sp seconds are a
rehearsal of two ranks on one card, not a scaling measurement.
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
# and data generation's: ModelScope's UNetSD attn1 at d = 64, levels 0 and 1
# of a 4-way phase-1 call (4 x 16 frames of 32x32 latents) and of a 2-way
# phase-2/3 call; last an sp rank's UNet attn1 (the edit's, half the frames)
DATAGEN_FLASH_SHAPES = [(64, 5, 1024, 64), (64, 10, 256, 64), (32, 5, 1024, 64),
                        (32, 10, 256, 64)]
FLASH_SHAPES = [(48, 8, 1536, 40), (48, 8, 384, 80), (16, 1, 1536, 512), (8, 1, 1536, 512),
                (16, 1, 1024, 512), (48, 8, 2304, 40), (48, 8, 576, 80), (16, 1, 2304, 512),
                (8, 1, 2304, 512)] + DATAGEN_FLASH_SHAPES + [(24, 8, 1536, 40), (24, 8, 384, 80)]
# kernel A': the edit's UNet attn1 shapes of kernel A (the VAE's one head
# takes A), then training's (16 frames at 256x256, where A' is on), then
# data generation's (A' there only with INSV2V_FLASH_HEADFOLD=1)
HEADFOLD_SHAPES = FLASH_SHAPES[:2] + [(16, 8, 1024, 40), (16, 8, 256, 80)] + DATAGEN_FLASH_SHAPES
# kernel B: (rows, C) of every spatial and motion FF at 48 frames of 32x48
# (the edit), at 16 frames of 32x32 (training), at 48 frames of 48x48
# (LOVEU), at an sp rank's 24 frames of 32x48
FF_SHAPES = [(73728, 320), (18432, 640), (4608, 1280), (1152, 1280),
             (16384, 320), (4096, 640), (1024, 1280), (256, 1280),
             (110592, 320), (27648, 640), (6912, 1280), (1728, 1280),
             (36864, 320), (9216, 640), (2304, 1280), (576, 1280)]
# kernel C: (B, P, F, heads, e) of the motion modules at levels 0..3, the
# edit's (32x48 latents), the LOVEU runner's (48x48), training's (one
# 16-frame video of 32x32 latents) and an sp rank's (the edit's, half the
# pixels after the all-to-all)
TEMPORAL_SHAPES = [(3, 1536, 16, 8, 40), (3, 384, 16, 8, 80), (3, 96, 16, 8, 160),
                   (3, 24, 16, 8, 160), (3, 2304, 16, 8, 40), (3, 576, 16, 8, 80),
                   (3, 144, 16, 8, 160), (3, 36, 16, 8, 160),
                   (1, 1024, 16, 8, 40), (1, 256, 16, 8, 80), (1, 64, 16, 8, 160),
                   (1, 16, 16, 8, 160),
                   (3, 768, 16, 8, 40), (3, 192, 16, 8, 80), (3, 48, 16, 8, 160),
                   (3, 12, 16, 8, 160)]
# kernel D: (rows, C) of the UNet's LayerNorms at 48 frames of 32x48 and
# of CLIP's (48 prompts of 77 tokens)
LN_SHAPES = [(73728, 320), (18432, 640), (4608, 1280), (48 * 77, 768)]
# kernel E: (N, M, channels of each part, SiLU) of the GroupNorms it takes
# on each path (32 groups). The edit's UNet call: ResnetBlock3D across
# frames (N = 3, M = 16 frames of 32x48 latents at level 0), the
# transformer and motion norms per frame (N = 48), the split-skip pairs;
# SDXL's level 0 and 1 920-channel pair at 96x96 latents. The VAE, a 4-D
# call per frame: the edit's encode (chunks of 16 frames at 256x384,
# levels 0-2 and the mid block) and decode (chunks of 8), the training
# encodes at 256x256, datagen's decode at 256x256, SDXL's decode at
# 768x768. Datagen's UNetSD (4 samples of 16 frames of 32x32): across
# frames, per frame, its widest concat. LOVEU's level 0 (48x48 latents).
GN_SHAPES = [(3, 24576, (320,), True), (3, 6144, (640,), True), (3, 1536, (1280,), True),
             (3, 384, (1280,), True), (48, 1536, (320,), False), (48, 384, (640,), False),
             (3, 24576, (640, 320), True), (3, 1536, (1280, 640), True),
             (3, 147456, (320,), True), (48, 9216, (320,), False), (3, 36864, (1280, 640), True),
             (16, 98304, (128,), True), (16, 24576, (256,), True), (16, 6144, (512,), True),
             (16, 1536, (512,), True), (8, 98304, (128,), True), (8, 24576, (256,), True),
             (8, 1536, (512,), True), (16, 65536, (128,), True), (16, 16384, (256,), True),
             (16, 1024, (512,), True), (8, 65536, (128,), True), (8, 589824, (128,), True),
             (4, 16384, (320,), True), (64, 1024, (320,), True), (4, 1024, (1280,), True),
             (64, 16, (2560,), True), (3, 36864, (320,), True), (48, 2304, (320,), False)]
EDIT_FRAMES, EDIT_HEIGHT, EDIT_WIDTH = 32, 256, 384  # bench.py's workload
# training: micro-batch 1 of 16 frames at 256x256, accumulation 2
TRAIN_FRAMES, TRAIN_SIZE, TRAIN_ACCUM = 16, 256, 2
TOL = {  # max |kernel - f32 twin|, bf16-level: 8 mantissa bits of O(1) outputs
    "flash_attention": 2e-2, "flash_attention_headfold": 2e-2, "fused_geglu_ff": 6e-2,
    "temporal_attention": 2e-2, "fused_layer_norm": 2e-2, "fused_group_norm": 2e-2}
# relative L2 of one edit UNet call through a UNet loaded from a Lightning
# checkpoint against the UNet it was written from: the same bf16 weights
# and kernels, so any reading above it is a weight the load missed
CKPT_TOL = 1e-3
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
# data generation: the JAX CLI's defaults (v2, 16 frames, latent 32, DDIM 30)
DATAGEN_PROMPT = {"input": "a cat walking on the grass", "output": "a dog walking on the grass",
                  "edit": "turn the cat into a dog"}
# relative L2 of RAFT's flow on the card (float32, cuDNN's default TF32
# convolutions) against the CPU's float32 run on the same weights and pairs
RAFT_TOL = 5e-2
# the multi-process rehearsals: two ranks share the card over gloo; each
# sharded window runs SP_STEPS DDIM steps; a two-rank result is held to
# its one-process counterpart at SHARD_TOL relative L2 (the bf16 gate)
RANKS, SP_STEPS, SHARD_TOL = 2, 4, 5e-2
# relative L2 of one full-width UNet call, frames sharded over RANKS,
# against the unsharded call on the card: twice the 1.21-1.25e-2 measured
# on an NVIDIA H100 80GB HBM3 at 700 W (bf16 roundings of other batch
# sizes). A GroupNorm whose statistics skip the other ranks' frames read
# 0.160 there on latents that drift over the window, and must read above
# it. The windows' SHARD_TOL cannot see that fault (2.84e-2 against a
# clean 2.69e-2: CFG 7.5 over 4 steps amplifies the bf16 noise)
SP_CALL_TOL = 2.5e-2
# relative L2 of one bf16 UNet call of the edit on the up blocks' split-skip
# path against the concat path on the same weights. Only bf16 roundings
# separate them (conv1 and the shortcut as two products rounded and summed,
# the split GroupNorm's one-pass variance): in float32 on the card they
# agree to SPLIT_F32_TOL (2.8e-6 read). On an NVIDIA H100 80GB HBM3 at
# 700 W each bf16 call read 1.18-1.21e-2 from the float32 call and the two
# 1.25e-2 from each other: bf16 noise, which the decoder carries to the
# output from any rounding. So the gate is twice one call's bf16 error, as
# SP_CALL_TOL's is
SPLIT_TOL, SPLIT_F32_TOL = 2.5e-2, 1e-4
# the split-skip default stays on unless the split call's device time is
# worse than the concat call's by more than this share
SPLIT_SLOWER = 0.01
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
        f"library {lib} ms, bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f} % of the bound")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "ms_source": {"ms": ms_clock, "plain_ms": plain_clock, "library_ms": lib_clock}}


def _log_grid(name, shape, grid):
    """A kernel's grid (blocks, threads, blocks resident an SM) and the
    waves it takes on this card's SMs; for a persistent grid (``units``)
    the work units and how many a block walks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = grid["blocks"] / (grid["resident"] * sms) if grid["resident"] else float("nan")
    units = ("" if "units" not in grid else
             f", {grid['units']} units of {grid['heads_per_unit']} heads, "
             f"{grid['units'] / grid['blocks']:.2f} a block")
    log(f"grid {name} {shape}: blocks {grid['blocks']} of {grid['threads']} threads, "
        f"{grid['resident']} resident an SM, {waves:.2f} waves on {sms} SMs{units}")


def phase_parity(gen):
    import torch.nn.functional as F

    from insv2v_torch.ops.attention import (flash_attention, flash_attention_headfold,
                                            flash_attention_reference, flash_grid,
                                            temporal_attention, temporal_attention_reference,
                                            temporal_grid)
    from insv2v_torch.ops.fused_ff import ff_grid, fused_geglu_ff, geglu_ff_reference
    from insv2v_torch.ops.fused_norm import (fused_group_norm, fused_group_norm_reference,
                                             fused_layer_norm, fused_layer_norm_reference,
                                             group_norm_grid, group_norm_plan, group_norm_rpar,
                                             layer_norm_grid)

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
        rows[-1]["grid"] = flash_grid(*shape, headfold=False)
        log(f"grid flash_attention {shape}: " + ", ".join(
            f"{key} {val}" for key, val in rows[-1]["grid"].items()))
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
        rows[-1]["grid"] = flash_grid(*shape, headfold=True)
        log(f"grid flash_attention_headfold {shape}: " + ", ".join(
            f"{key} {val}" for key, val in rows[-1]["grid"].items()))
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
        rows[-1]["grid"] = temporal_grid(*shape)
        _log_grid("temporal_attention", shape, rows[-1]["grid"])
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
        _log_grid("fused_layer_norm", (n, c), layer_norm_grid(n, c))
    entries.append(_entry("fused_layer_norm", "insv2v_torch/csrc/layer_norm.cu",
                          "insv2v_tpu/ops/fused_norm.py:22", rows))

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, m, widths, silu in GN_SHAPES:
        c = sum(widths)
        parts = tuple((rnd(n, m, w).float() * 2 + 0.5).to(torch.bfloat16) for w in widths)
        # the models' bf16 affine, as the GroupNorm modules hand it over
        gw, gb = (1.0 + 0.1 * rnd(c).float()).bfloat16(), (0.1 * rnd(c).float()).bfloat16()
        out = fused_group_norm(parts, gw, gb, 32, 1e-5, silu)
        ref = fused_group_norm_reference(tuple(p.float() for p in parts), gw, gb, 32, 1e-5, silu)
        err = max((o.float() - r).abs().max().item() for o, r in zip(out, ref))
        # the library's best case: F.group_norm on channels-first rows, then F.silu
        cf = torch.cat(parts, -1).transpose(1, 2).contiguous()
        lib = lambda: F.silu(F.group_norm(cf, 32, gw, gb, 1e-5)) if silu else \
            F.group_norm(cf, 32, gw, gb, 1e-5)
        bms, by = bound(10.0 * n * m * c, 2.0 * 2 * n * m * c)
        shape = (n, m, "+".join(map(str, widths)), "silu" if silu else "-")
        rows.append(_report("fused_group_norm", shape, err,
                            lambda: fused_group_norm(parts, gw, gb, 32, 1e-5, silu),
                            lambda: fused_group_norm_reference(parts, gw, gb, 32, 1e-5, silu),
                            lib, 20, bms, by))
        grid = group_norm_grid(c, group_norm_rpar(c))
        slots = sms * min(grid["resident_stats"], grid["resident_apply"])
        rpar, rows_a_block, chunks = group_norm_plan(n, m, c, slots)
        rows[-1]["grid"] = dict(grid, blocks=n * chunks, rows=rows_a_block)
        log(f"grid fused_group_norm {shape}: {n * chunks} blocks of {grid['threads']} threads "
            f"over {rows_a_block} rows, resident an SM {grid['resident_stats']} (stats) / "
            f"{grid['resident_apply']} (apply), "
            f"{n * chunks / (grid['resident_apply'] * sms):.2f} waves on {sms} SMs")
    entries.append(_entry("fused_group_norm", "insv2v_torch/csrc/group_norm.cu", None, rows))
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


def _write_lightning(path, unet, drop=None):
    """The UNet's weights as the reference's trainer saves a checkpoint:
    Lightning's ``state_dict`` under DeepSpeed's ``_forward_module.``, with
    pickled ``hyper_parameters`` (which the safe unpickler refuses) beside
    them; ``drop``: a key left out. Returns the seconds to write."""
    t0 = time.perf_counter()
    sd = {f"_forward_module.unet.{k}": v.cpu() for k, v in unet.state_dict().items()
          if k != drop}
    torch.save({"state_dict": sd, "epoch": 0, "global_step": 0,
                "hyper_parameters": argparse.Namespace(lr=1e-5, accumulate_grad_batches=2)},
               path)
    return time.perf_counter() - t0


def phase_ckpt(models, args, gen):
    """The edit's entry point on a checkpoint in the reference's Lightning
    form: the full-width UNet's weights written to a file, then
    ``make_editor`` (the edit CLI's loader; its VAE and text model stay at
    seed + 1) loads it. Every UNet tensor must come back bit-equal, and one
    edit UNet call (3 x 16 frames of 32x48) through kernels A, B and C must
    agree with the source UNet's within CKPT_TOL. Then a planted fault: the
    same file without one motion-module tensor (a strict=False load keeps
    seed + 1's value), whose call must read above the gate."""
    import tempfile
    import warnings

    from insv2v_torch.apps.edit_video import make_editor

    unet = models["unet"]
    src = unet.state_dict()
    x = torch.randn(3, 16, 32, 48, 8, generator=gen).cuda().bfloat16()
    ctx = torch.randn(3, 77, 768, generator=gen).cuda().bfloat16()
    t = torch.full((3,), 501, device="cuda")
    with torch.no_grad():
        ref = unet(x, t, ctx, video_start_index=0).float()
    drop = next(k for k in src if ".motion_modules." in k and k.endswith("proj_out.weight"))
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, dropped in (("whole", None), ("planted", drop)):
            path = os.path.join(tmp, f"{label}.ckpt")
            write_s = _write_lightning(path, unet, dropped)
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                editor = make_editor(CONFIG, path, "ddim", args.steps, False, device="cuda",
                                     seed=args.seed + 1)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            os.remove(path)
            fell_back = any("falling back to torch.load" in str(w.message) for w in caught)
            loaded = editor.unet.state_dict()
            differ = [k for k in src if not torch.equal(loaded[k], src[k])]
            _zero_launches()
            with torch.no_grad():
                got = editor.unet(x, t, ctx, video_start_index=0).float()
            torch.cuda.synchronize()
            launches = _read_launches(f"ckpt ({label})", ("flash_attention", "fused_geglu_ff",
                                                          "temporal_attention"))
            rel = ((got - ref).norm() / ref.norm()).item()
            readings[label] = {"differ": differ, "rel": rel, "fell_back": fell_back,
                               "finite": bool(torch.isfinite(got).all()), "launches": launches}
            log(f"ckpt {label}: Lightning file of {len(src) - (dropped is not None)} UNet "
                f"tensors, {size / 2 ** 30:.3f} GiB, written in {write_s:.2f} s, loaded through "
                f"make_editor (models built at seed {args.seed + 1}) in {load_s:.2f} s; loader "
                f"fell back to weights_only=False with its warning: {fell_back}; tensors not "
                f"bit-equal to the source: {len(differ)} {differ[:3]}; one edit UNet call "
                f"(3x16x32x48) rel L2 vs the source UNet {rel:.3e} (gate {CKPT_TOL:g})")
            del editor, loaded, got
            torch.cuda.empty_cache()
    whole, planted = readings["whole"], readings["planted"]
    if not (whole["fell_back"] and not whole["differ"] and whole["finite"]
            and whole["rel"] <= CKPT_TOL):
        raise AssertionError(f"the Lightning checkpoint did not load whole: {whole}")
    if not (planted["differ"] == [drop] and planted["rel"] > CKPT_TOL):
        raise AssertionError(f"the gate missed the dropped tensor {drop}: {planted}")
    return whole["launches"]


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
    from insv2v_torch.models.unet3d import uses_split_skip

    up = "split-skip" if uses_split_skip(models["unet"].cfg, 3) else "concat"
    log(f"edit: {f} frames {hgt}x{wid}, DDIM {args.steps} steps, "
        f"{len(windows)} windows, dual CFG (3x batch = {3 * 16} frames per UNet call), "
        f"up blocks on the {up} path")
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


def phase_demo(args, gen):
    """The web demo at its defaults (DDPM 20, 384x384, 32 frames, random
    weights) served on a free local port in a thread: the form, then two
    edits of a 40-frame mp4 (8 fps, written by cv2), the first with motion
    compensation off and answered as the raw GIF, the second with it on
    (Farneback through "auto": no RAFT weights) and answered inline, each
    a GIF of (32, 384, 768, 3) with A, B and C launched; a body over
    ``MAX_BODY_BYTES`` refused with 413 before it is read."""
    import base64
    import http.client
    import re
    import tempfile
    import threading

    import cv2
    import numpy as np

    from insv2v_torch.apps import gradio_demo, web_demo
    from insv2v_torch.utils.media import load_gif

    os.environ.pop("INSV2V_RAFT_WEIGHTS", None)
    demo_args = web_demo.build_parser().parse_args(
        ["--config", CONFIG, "--allow-random-weights", "--port", "0"])
    server = web_demo.make_server(demo_args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def request(method, target, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request(method, target, body=body, headers=headers or {})
        resp = conn.getresponse()
        out = (resp.status, resp.getheader("Content-Type"), resp.read())
        conn.close()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        try:
            video = (_edit_frames(gen, 40, 480, 640) * 127.5 + 127.5).round().astype(np.uint8)
            path = os.path.join(tmp, "in.mp4")
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (640, 480))
            for fr in video:
                vw.write(fr[..., ::-1].copy())
            vw.release()
            data = open(path, "rb").read()
            status, _, page = request("GET", "/")
            if status != 200 or b'action="/edit"' not in page:
                raise AssertionError(f"demo form: status {status}")
            t0 = time.perf_counter()
            gradio_demo.get_editor(demo_args)  # the lazy editor, built before the timings
            log(f"demo: editor built in {time.perf_counter() - t0:.3f} s")
            _zero_launches()
            for motion in (False, True):
                boundary = "insv2v-demo"
                fields = [("video", data, 'filename="in.mp4"'), ("prompt", b"make it snowy", ""),
                          ("seed", b"0", "")] + ([("motion_comp", b"on", "")] if motion else [])
                body = b"".join(
                    f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
                    f'{"; " + extra if extra else ""}\r\n\r\n'.encode() + value + b"\r\n"
                    for name, value, extra in fields) + f"--{boundary}--\r\n".encode()
                headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
                if not motion:
                    headers["Accept"] = "image/gif"
                t0 = time.perf_counter()
                status, ctype, answer = request("POST", "/edit", body, headers)
                secs = time.perf_counter() - t0
                if status != 200:
                    raise AssertionError(f"demo edit: status {status}: {answer[:200]}")
                if not motion:
                    gif_bytes = answer
                else:
                    gif_bytes = base64.b64decode(re.search(
                        rb"data:image/gif;base64,([A-Za-z0-9+/=]+)", answer).group(1))
                out = os.path.join(tmp, f"answer_{int(motion)}.gif")
                with open(out, "wb") as f:
                    f.write(gif_bytes)
                gif = load_gif(out)
                log(f"demo: POST /edit, motion compensation {'on' if motion else 'off'}: "
                    f"{secs:.3f} s, answered {ctype}, GIF {gif.shape}")
                if gif.shape != (32, 384, 768, 3) or not np_finite(gif):
                    raise AssertionError(f"demo GIF {gif.shape}")
            counts = _read_launches("demo", ("flash_attention", "fused_geglu_ff",
                                             "temporal_attention"))
            status, _, _ = request("POST", "/edit", None, {
                "Content-Length": str(web_demo.MAX_BODY_BYTES + 1),
                "Content-Type": "multipart/form-data; boundary=x"})
            log(f"demo: a body over MAX_BODY_BYTES answered {status}")
            if status != 413:
                raise AssertionError(f"demo: an oversized body answered {status}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            gradio_demo._EDITOR = None  # the demo's models go
    return counts


def phase_t5(args, gen):
    """T5 v1.1-large (24 blocks at d_model 1024, random weights from the
    seed) in bf16 on the card against the same bf16-rounded weights in
    float32 on the CPU, on 2 x 77 ids: relative L2 under the bf16 gate and
    ms per encode; then ``ClipT5Encoder`` over the ViT-L/14 text tower and
    T5 on the card, its two outputs' shapes."""
    import copy

    from insv2v_torch.models.t5_text import build_clip_t5_encoder, build_t5_encoder

    cpu = build_t5_encoder(device="cpu", dtype=torch.bfloat16, seed=args.seed).float()
    ids = torch.randint(0, cpu.cfg.vocab_size, (2, 77), generator=gen)
    with torch.no_grad():
        ref = cpu(ids)
        gpu = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
        del cpu
        ids_gpu = ids.cuda()
        got = gpu(ids_gpu)
        ms = time_ms(lambda: gpu(ids_gpu), 10)
    got = got.cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"t5 v1.1-large: GPU bf16 vs CPU f32 rel L2 {rel:.3e} (tol {UNET_TOL:g}); "
        f"{ms:.3f} ms per encode of 2 x 77 ids; output {tuple(got.shape)} {got.dtype}")
    if not (got.dtype == torch.float32 and torch.isfinite(got).all() and rel <= UNET_TOL):
        raise AssertionError(f"T5 on the card disagrees with the CPU: {rel}")
    del gpu
    enc = build_clip_t5_encoder(device="cuda", seed=args.seed)
    clip_ids = torch.randint(0, 49408, (2, 77), generator=gen).cuda()
    with torch.no_grad():
        clip_z, t5_z = enc(clip_ids, ids_gpu)
    log(f"t5: ClipT5Encoder (ViT-L/14 text + T5 v1.1-large): {tuple(clip_z.shape)}, "
        f"{tuple(t5_z.shape)}")
    if (clip_z.shape != (2, 77, 768) or t5_z.shape != (2, 77, 1024)
            or not (torch.isfinite(clip_z).all() and torch.isfinite(t5_z).all())):
        raise AssertionError(f"ClipT5Encoder outputs {clip_z.shape} {t5_z.shape}")


def _wake_zero_weights(model, gen):
    """ModelScope zero-inits the last conv of every ResBlock, temporal conv
    stack and the output head, and each transformer's proj_out, which
    would hide those paths (kernel A's attention among them) from an
    output check: give every all-zero weight random values of unit gain
    (std fan_in ** -0.5), drawn on the CPU from ``gen``."""
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2 and not p.any():
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)


def phase_datagen(args, gen):
    """Data generation on the card. First the full-width ModelScope UNetSD
    (random weights from the seed, its zero-initialised weights woken), one
    call in bf16 on the GPU against the same bf16-rounded weights in
    float32 on the CPU, on 2 frames of 16x16 latents (level 0 at S = 256
    takes kernel A at d = 64): a plain context (batch 2), the (key, value)
    tuple (batch 2) and the 4-way ``sa_share`` batch. Then
    ``apps/generate_dataset.main`` at the CLI defaults (v2, 16 frames,
    latent 32, DDIM 30; full-width UNetSD, OpenCLIP ViT-H/14 text and VAE
    in bf16, built on the card) for one prompt triple, one attempt, the
    UNetSD loaded from that woken state dict (``--unet-ckpt``; the text
    tower and the VAE random), with the CLIP filter on over a random
    ViT-L/14 checkpoint (``--clip-filter-ckpt``); then one v1 pair without
    the filter. Seconds per pair and per UNetSD call
    of each phase, text-encode and decode seconds, peak memory, kernel A's
    launches per pair; the written folders are read back."""
    import copy
    import tempfile

    import numpy as np

    from insv2v_torch.apps import generate_dataset
    from insv2v_torch.data.datasets import VideoPromptToPromptDataset
    from insv2v_torch.models.modelscope_t2v import ModelScopeConfig, UNetSD
    from insv2v_torch.utils.clip_metrics import clip_models

    cfg = ModelScopeConfig()
    t0 = time.perf_counter()
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        unet = UNetSD(cfg)
    _wake_zero_weights(unet, gen)
    unet = unet.to(torch.bfloat16).eval()
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    log(f"datagen: UNetSD full width, {sum(p.numel() for p in unet.parameters()) / 1e6:.1f} M "
        f"parameters, built on the card in {time.perf_counter() - t0:.1f} s")
    x4 = torch.randn(4, 2, 16, 16, 4, generator=gen)
    ctx = [torch.randn(4, 77, cfg.context_dim, generator=gen) for _ in range(2)]
    t = torch.tensor(501)
    cases = {"plain context": (x4[:2], ctx[0][:2], False),
             "(key, value) tuple": (x4[:2], (ctx[0][:2], ctx[1][:2]), False),
             "4-way sa_share": (x4, ctx[0], True)}
    cuda = lambda c: tuple(a.cuda() for a in c) if isinstance(c, tuple) else c.cuda()
    for label, (x, c, share) in cases.items():
        with torch.no_grad():
            ref = cpu(x, t, c, sa_share=share)
            _zero_launches()
            got = unet(x.cuda(), t.cuda(), cuda(c), sa_share=share).float().cpu()
            counts = _read_launches(f"UNetSD check ({label})", ("flash_attention",))
        rel = ((got - ref).norm() / ref.norm()).item()
        log(f"datagen UNetSD full width, {x.shape[0]}x2x16x16 latent, {label}: rel L2 err GPU "
            f"bf16 vs CPU f32 {rel:.3e} (tol {UNET_TOL:g}), max |ref| "
            f"{ref.abs().max().item():.3f}, kernel A launches {counts['flash_attention']}")
        if not (torch.isfinite(got).all() and rel <= UNET_TOL):
            raise AssertionError(f"UNetSD GPU/CPU disagreement, {label}: {rel}")
    del cpu
    # where one UNetSD call of the generation spends its device time: the
    # 4-way phase-1 call and a 2-way call of phases 2-3 (16 frames of 32x32)
    for label, b, share in (("one 4-way phase-1 UNetSD call", 4, True),
                            ("one 2-way UNetSD call", 2, False)):
        x = torch.randn(b, 16, 32, 32, 4, generator=gen).cuda()
        c = torch.randn(b, 77, cfg.context_dim, generator=gen).cuda()
        _profile_call(lambda: unet(x, t.cuda(), c, sa_share=share), "datagen profile", label)
    with tempfile.TemporaryDirectory() as tmp:
        unet_ckpt = os.path.join(tmp, "unet_sd.pth")
        torch.save(unet.state_dict(), unet_ckpt)
        del unet
        torch.cuda.empty_cache()
        prompts = os.path.join(tmp, "prompts.json")
        with open(prompts, "w") as f:
            json.dump([DATAGEN_PROMPT], f)
        clip_ckpt = os.path.join(tmp, "clip_vit_l14.bin")
        torch.save({k: v.to(torch.bfloat16) for m in clip_models(seed=args.seed).values()
                    for k, v in m.state_dict().items()}, clip_ckpt)
        argv = ["--prompts", prompts, "--unet-ckpt", unet_ckpt, "--allow-random-weights",
                "--num-samples", "1", "--max-attempts", "1", "--seed", str(args.seed)]
        runs = {}
        for version, extra in (("v2", ["--clip-filter-ckpt", clip_ckpt]),
                               ("v1", ["--no-clip-filter"])):
            out = os.path.join(tmp, version)
            _zero_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = generate_dataset.main(argv + ["--output-dir", out, "--ptp-version", version]
                                        + extra)
            wall = time.perf_counter() - t0
            counts = _read_launches(f"datagen {version}", ("flash_attention",))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rec, st = res["records"][0], res["timings"][0]
            sa, steps = st["sa_steps"], generate_dataset.build_parser().get_default("steps")
            calls = sa + 2 * (steps - sa)  # phase 1: one call a step; then two
            log(f"datagen {version}: {wall:.3f} s with model build; pair {st['pair']:.3f} s: text "
                f"encode {st['text']:.3f} s, sampling {st['sample']:.3f} s (phase 1 "
                f"{st['phase1']:.3f}, 2 {st['phase2']:.3f}, 3 {st['phase3']:.3f}; sa/ca steps "
                f"{sa}/{st['ca_steps']}), VAE decode {st['decode']:.3f} s, CLIP score "
                f"{st['score']:.3f} s, write {st['write']:.3f} s; peak memory {peak:.2f} GiB")
            per_2way = (st["phase2"] + st["phase3"]) / (2 * (steps - sa))
            phase1 = st["phase1"] / sa
            log(f"datagen {version}: per UNetSD call: phase 1 {phase1:.4f} s "
                f"({'4-way' if version == 'v2' else '2-way'}), phases 2-3 {per_2way:.4f} s "
                f"(2-way); {calls} UNetSD calls; kernel A launches {counts['flash_attention']} "
                f"(d = 64: 10 per UNetSD call = {10 * calls}, + 2 VAE decodes at d = 512)")
            log(f"datagen {version} record: {rec}")
            if counts["flash_attention"] != 10 * calls + 2:
                raise AssertionError(f"datagen {version}: {counts['flash_attention']} launches of "
                                     f"kernel A, not {10 * calls + 2}")
            scores = [rec[k] for k in ("sim_0", "sim_1", "sim_dir", "sim_image")]
            if not (rec["ptp_version"] == version and all(map(math.isfinite, scores))):
                raise AssertionError(f"datagen {version} record {rec}")
            sample = os.path.join(out, "sample_000000")
            jpgs = [f for f in os.listdir(os.path.join(sample, "image")) if f.endswith(".jpg")]
            if len(jpgs) != (32 if rec["accepted"] else 0) or not os.path.exists(
                    os.path.join(sample, "prompt.json")):
                raise AssertionError(f"datagen {version}: {len(jpgs)} JPEGs, record {rec}")
            if rec["accepted"]:
                item = VideoPromptToPromptDataset(out, num_frames=16,
                                                  rng=np.random.RandomState(0))[0]
                if item["input_video"].shape != (16, 256, 256, 3) or item["edited_video"].shape \
                        != (16, 256, 256, 3) or item["output_prompt"] != DATAGEN_PROMPT["output"]:
                    raise AssertionError(f"datagen {version}: read back {item['input_video'].shape}")
                log(f"datagen {version}: 32 JPEGs, prompt.json, the record and the GIF written; "
                    f"the dataset reads the pair back ({item['input_video'].shape})")
            runs[version] = (counts, rec)
    if not runs["v1"][1]["accepted"]:
        raise AssertionError("datagen v1 without the filter was not accepted")
    return runs["v2"][0]


def _kernel_fns():
    """Every kernel wrapper, by name; each counts its own launches."""
    from insv2v_torch.ops.attention import (flash_attention, flash_attention_headfold,
                                            temporal_attention)
    from insv2v_torch.ops.fused_ff import fused_geglu_ff
    from insv2v_torch.ops.fused_norm import fused_group_norm, fused_layer_norm

    fns = (flash_attention, flash_attention_headfold, fused_geglu_ff, temporal_attention,
           fused_layer_norm, fused_group_norm)
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


PROFILE_CLASSES = (  # kernel-name fragments, matched in this order; the rest is
    ("kernel A (flash)", ("flash_fwd",)), ("kernel B (ff)", ("ff_gate", "ff_out")),
    ("kernel C (temporal)", ("temporal_attn",)),  # "other elementwise"
    ("convolution", ("conv", "fprop", "implicit", "winograd")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy", "nchwtonhwc", "nhwctonchw")),
    ("norms", ("norm", "welford", "reduce")))


def _kernel_class(key: str) -> str:
    name = key.lower()
    return next((c for c, frags in PROFILE_CLASSES if any(f in name for f in frags)),
                "other elementwise")


def _class_ms(kernels) -> dict:
    """Device ms of profiler kernel events summed by PROFILE_CLASSES."""
    by_class = {}
    for e in kernels:
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    return by_class


def _by_class(kernels) -> str:
    return ", ".join(f"{c} {ms:.2f} ms" for c, ms in sorted(_class_ms(kernels).items(),
                                                             key=lambda kv: -kv[1]))


def _profile_call(call, tag, label):
    """One call's synchronised wall time, then its device time under
    torch.profiler summed by kernel class, and the device's busy share of
    the wall time; the dozen longest kernels. Returns the numbers (None
    where the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        log(f"{tag}: the profiler recorded no device time; breakdown not measured")
        return None
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"{tag}: {label} {wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
        f"(idle share {idle:.3f}); by class: {_by_class(kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"{tag}:   {e.self_device_time_total / 1e3:8.3f} ms  {e.count:4d} calls  "
            f"{e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": idle,
            "classes": _class_ms(kernels),
            "copies": [(e.key, e.count, e.self_device_time_total / 1e3) for e in kernels
                       if _kernel_class(e.key) == "copies"]}


def phase_profile(models, gen):
    """Where one UNet call of the edit (3 x 16 frames of 32x48) spends its
    device time: torch.profiler over one call, kernel time summed by class,
    and the device's busy share of the call's synchronised wall time."""
    unet = models["unet"]
    x = torch.randn(3, 16, 32, 48, 8, generator=gen).cuda().bfloat16()
    ctx = torch.randn(3, 77, 768, generator=gen).cuda().bfloat16()
    t = torch.full((3,), 501, device="cuda")
    _profile_call(lambda: unet(x, t, ctx, video_start_index=0), "profile", "one UNet call")


@contextlib.contextmanager
def _plain_twins():
    """The UNet's kernel calls (A, B, C) routed to their plain twins for a
    ``with`` block, so that it runs in float32 on the card."""
    from insv2v_torch.models import unet3d
    from insv2v_torch.ops import attention, fused_ff

    saved = attention.flash_attention, unet3d.temporal_attention, unet3d.geglu_ff
    attention.flash_attention = lambda q, k, v, scale=None, headfold=None: \
        attention.flash_attention_reference(q, k, v, scale)
    unet3d.temporal_attention = attention.temporal_attention_reference
    unet3d.geglu_ff = fused_ff.geglu_ff_reference
    try:
        yield
    finally:
        attention.flash_attention, unet3d.temporal_attention, unet3d.geglu_ff = saved


def _conv1_weight_copies(unet, path, x, t, ctx):
    """What conv1's kernel layout costs: the 12 up-block conv1s at the edit
    call's shapes, device ms of the whole kernel on the concat input and of
    the two slices on the parts, each with the kernels as stored (cuDNN's
    channels-last convolution copies a kernel that is not channels-last
    contiguous at every call) and made channels-last beforehand (what the
    split path keeps, ``unet3d._kernel_parts``)."""
    import torch.nn.functional as F

    shapes = []
    hooks = [r.register_forward_pre_hook(
        lambda mod, a, kw: shapes.append((mod, a[0].shape, kw["skip"].shape)), with_kwargs=True)
        for blk in unet.up_blocks for r in blk.resnets]
    with torch.no_grad(), path(unet, True):
        unet(x, t, ctx, video_start_index=0)
    for h in hooks:
        h.remove()
    cl = torch.channels_last
    calls = []
    for mod, xs, ss in shapes:
        b, f, hh, ww, c1 = xs
        c2 = ss[-1]
        nchw = lambda c: torch.randn(b * f, c, hh, ww, device="cuda", dtype=torch.bfloat16
                                     ).contiguous(memory_format=cl)
        w, bias = mod.conv1.weight, mod.conv1.bias
        calls.append((nchw(c1 + c2), nchw(c1), nchw(c2), c1, w, bias))
    conv = lambda inp, wt, bs: F.conv2d(inp, wt, bs, padding=1)
    variants = {
        "whole, as stored": lambda: [conv(xc, w, bs) for xc, _, _, _, w, bs in calls],
        "slices, as stored": lambda: [(conv(x1, w[:, :c1], bs), conv(x2, w[:, c1:], None))
                                      for _, x1, x2, c1, w, bs in calls]}
    made = [(xc, x1, x2, w.contiguous(memory_format=cl), w[:, :c1].contiguous(memory_format=cl),
             w[:, c1:].contiguous(memory_format=cl), bs) for xc, x1, x2, c1, w, bs in calls]
    variants["whole, channels-last"] = lambda: [conv(xc, w, bs) for xc, _, _, w, _, _, bs in made]
    variants["slices, channels-last"] = lambda: [(conv(x1, wa, bs), conv(x2, wb, None))
                                                 for _, x1, x2, _, wa, wb, bs in made]
    params = sum(c[4].numel() for c in calls)
    with torch.no_grad():
        times = {name: device_ms(fn, 5)[0] for name, fn in variants.items()}
    log(f"split: the 12 up-block conv1s ({params / 1e6:.1f} M kernel parameters), device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


def phase_split(models, gen):
    """The up blocks' split-skip path (``INSV2V_SPLIT_SKIP``, on by default
    at batch <= 3) against the concat path: one UNet call of the edit (3 x
    16 frames of 32x48 latents) on the same bf16 weights, which must agree
    to SPLIT_TOL and launch A, B and C on the split path; both paths in
    float32 on the card through the plain twins (TF32 off), which must
    agree to SPLIT_F32_TOL, and each bf16 call against that float32 call;
    the split call on the unet phase's small latent against the CPU's
    float32 concat call; then each bf16 call profiled twice in turn
    (device busy ms, by class, idle share, the copy kernels), the least
    busy time of each path deciding whether the default should stay on,
    and timed back to back in turns (wall per call, host gaps included)."""
    import copy
    import dataclasses

    from insv2v_torch.models.unet3d import uses_split_skip

    unet = models["unet"]
    cfg = unet.cfg
    x = torch.randn(3, 16, 32, 48, 8, generator=gen).cuda().bfloat16()
    ctx = torch.randn(3, 77, 768, generator=gen).cuda().bfloat16()
    t = torch.full((3,), 501, device="cuda")
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()

    @contextlib.contextmanager
    def path(model, split):
        saved = model.cfg
        model.cfg = dataclasses.replace(saved, split_skip=split)
        try:
            yield
        finally:
            model.cfg = saved

    with torch.no_grad():
        with path(unet, True):
            _zero_launches()
            got = unet(x, t, ctx, video_start_index=0).float()
            counts = _read_launches("split", ("flash_attention", "fused_geglu_ff",
                                              "temporal_attention"))
        with path(unet, False):
            want = unet(x, t, ctx, video_start_index=0).float()
        f32 = copy.deepcopy(unet).float()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with _plain_twins():
                ref = {}
                for split in (True, False):
                    with path(f32, split):
                        ref[split] = f32(x.float(), t, ctx.float(), video_start_index=0)
        finally:
            torch.backends.cudnn.allow_tf32 = True
        del f32
    errs = {"bf16": rel(got, want), "f32": rel(ref[True], ref[False]),
            "split_vs_f32": rel(got, ref[False]), "concat_vs_f32": rel(want, ref[False])}
    log(f"split: one UNet call of the edit (3 x 16 x 32x48), split-skip vs concat up blocks "
        f"on the card: bf16 rel L2 {errs['bf16']:.3e} (tol {SPLIT_TOL:g}), float32 through the "
        f"twins {errs['f32']:.3e} (tol {SPLIT_F32_TOL:g}); against the float32 call, bf16 "
        f"split-skip {errs['split_vs_f32']:.3e}, concat {errs['concat_vs_f32']:.3e} (tol "
        f"{UNET_TOL:g}); the edit's calls (batch 3) take the "
        f"{'split-skip' if uses_split_skip(cfg, 3) else 'concat'} path by default")
    if not (torch.isfinite(got).all() and errs["bf16"] <= SPLIT_TOL
            and errs["f32"] <= SPLIT_F32_TOL and errs["split_vs_f32"] <= UNET_TOL
            and errs["concat_vs_f32"] <= UNET_TOL):
        raise AssertionError(f"split-skip UNet call disagrees with the concat call: {errs}")

    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    cpu.cfg = dataclasses.replace(cfg, split_skip=False)
    xs, ctxs = torch.randn(1, 2, 32, 32, 8, generator=gen), torch.randn(1, 77, 768, generator=gen)
    ts = torch.tensor([501])
    with torch.no_grad():
        small_ref = cpu(xs, ts, ctxs, video_start_index=4)
        del cpu
        with path(unet, True):
            small = unet(xs.cuda(), ts.cuda(), ctxs.cuda(), video_start_index=4).float().cpu()
    rel_cpu = rel(small, small_ref)
    log(f"split: 2x32x32 latent, split-skip GPU bf16 vs concat CPU f32: rel L2 {rel_cpu:.3e} "
        f"(tol {UNET_TOL:g})")
    if not (torch.isfinite(small).all() and rel_cpu <= UNET_TOL):
        raise AssertionError(f"split-skip UNet call disagrees with the CPU: {rel_cpu}")

    _conv1_weight_copies(unet, path, x, t, ctx)
    profiles = {True: [], False: []}
    for _ in range(2):
        for split in (True, False):
            with path(unet, split):
                profiles[split].append(_profile_call(
                    lambda: unet(x, t, ctx, video_start_index=0), "split",
                    f"one UNet call, {'split-skip' if split else 'concat'} up blocks"))
    if any(p is None for ps in profiles.values() for p in ps):
        log("split: a profile recorded no device time; the default's check not measured")
        return counts
    for split in (True, False):
        name = "split-skip" if split else "concat"
        for key, n, ms in sorted(profiles[split][0]["copies"], key=lambda c: -c[2]):
            log(f"split: {name} copy kernels {ms:8.3f} ms {n:4d} calls  {key[:100]}")
    walls = {True: [], False: []}
    with torch.no_grad():
        for split in (True, False, False, True):  # in turns: wall per call, host gaps included
            with path(unet, split):
                walls[split].append(time_ms(lambda: unet(x, t, ctx, video_start_index=0), 10))
    log("split: wall ms per call over 10 back to back (CUDA events), in turns: split-skip "
        + " / ".join(f"{w:.3f}" for w in walls[True]) + ", concat "
        + " / ".join(f"{w:.3f}" for w in walls[False]))
    busy = {s: min(p["busy_ms"] for p in ps) for s, ps in profiles.items()}
    copies = {s: min(p["classes"].get("copies", 0.0) for p in ps) for s, ps in profiles.items()}
    worse = busy[True] / busy[False] - 1
    log(f"split: device busy per call, least of 2: split-skip {busy[True]:.3f} ms, concat "
        f"{busy[False]:.3f} ms ({100 * worse:+.2f} %); copies {copies[True]:.3f} / "
        f"{copies[False]:.3f} ms: " + (
            f"the split path is worse by more than {100 * SPLIT_SLOWER:g} %, so its default "
            "should be off" if worse > SPLIT_SLOWER else
            f"within {100 * SPLIT_SLOWER:g} % of the concat path or better: the default stays on"))
    return counts


# --- the native loader ---------------------------------------------------------

def _host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``reps`` calls (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _crops(rs, n, size, share=0.8):
    """Translation crops of ``share`` of the frame, inside it."""
    import numpy as np

    c = np.full(n, int(size * share), np.int32)
    centre = (c / 2 + rs.rand(2, n) * (size - c)).astype(np.float32)
    return centre[0], centre[1], c, c.copy()


def phase_loader(models, args):
    """The three native batch ops at the training size (16 frames of
    256x256 uint8; the resize from 512x512) against their numpy twins,
    with host ms; then the train phase's step (micro-batch 1, accumulation
    2, remat, A' on) fed by batches that the native crop op assembles from
    uint8 videos, pinned and copied without blocking, with the prefetch
    loader off and on: seconds per microbatch and the device's idle share
    (reported, no limit)."""
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from insv2v_torch.data import native_loader as nl
    from insv2v_torch.text.tokenizer import HashTokenizer
    from insv2v_torch.training.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    nl.load()
    log(f"loader: native library {nl.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(args.seed)
    f, size = TRAIN_FRAMES, TRAIN_SIZE
    u8 = rs.randint(0, 256, (f, size, size, 3), dtype=np.uint8)
    big = rs.randint(0, 256, (f, 2 * size, 2 * size, 3), dtype=np.uint8)
    crop = _crops(rs, f, size)
    ops = (("normalize_frames", lambda native: nl.normalize_frames(u8, native=native)),
           ("resize_normalize 512->256",
            lambda native: nl.resize_normalize(big, size, size, native=native)),
           ("crop_resize_normalize", lambda native: nl.crop_resize_normalize(
               u8, *crop, native=native)))
    for name, op in ops:
        err = float(np.abs(op(True) - op(False)).max())
        log(f"loader: {name} ({f}, {size}, {size}, 3) uint8: max |native - twin| {err:.3e} "
            f"(tol 1e-5), native {_host_ms(lambda: op(True)):.2f} ms, numpy twin "
            f"{_host_ms(lambda: op(False)):.2f} ms ({os.cpu_count()} host cores)")
        if not err <= 1e-5:
            raise AssertionError(f"native {name} disagrees with its twin: {err}")

    unet, vae, text = models["unet"], models["vae"], models["text_model"]
    unet.cfg = dataclasses.replace(unet.cfg, remat=True)
    ids = np.asarray(HashTokenizer()(["make it snowy", "turn the dog into a cat"]))
    vid_rs = np.random.RandomState(args.seed + 1)

    def make_batch():
        vids = vid_rs.randint(0, 256, (TRAIN_ACCUM * 2 * f, size, size, 3), dtype=np.uint8)
        x = nl.crop_resize_normalize(vids, *_crops(vid_rs, len(vids), size))
        x = torch.from_numpy(x.reshape(TRAIN_ACCUM, 2, f, size, size, 3))
        return {"input_video": x[:, 0].pin_memory(), "edited_video": x[:, 1].pin_memory(),
                "prompt_ids": torch.from_numpy(ids)}

    log(f"loader: one step's batch assembled on the host in {_host_ms(make_batch, 3):.1f} ms "
        f"(2 x {TRAIN_ACCUM} videos of {f} uint8 frames, crop + normalize, pinned)")
    trainer = Trainer(unet, vae, text, TrainConfig(lr=1e-5, accumulate_grad_batches=TRAIN_ACCUM))
    state = trainer.create_state()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def step(get, profiled=False):
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx as prof:
            host = get()
            batch = {k: v.to("cuda", non_blocking=True) for k, v in host.items()}
            trainer.train_step(state, batch, gen)
            torch.cuda.synchronize()
        return time.perf_counter() - t0, prof

    with _switches(True, False):
        step(make_batch)  # warm-up
        for prefetch in (False, True):
            loader = nl.PrefetchLoader(make_batch, depth=2) if prefetch else None
            get = (lambda: next(loader)) if prefetch else make_batch
            try:
                if prefetch:
                    step(get)  # fills the queue: the first batch is not overlapped
                walls = [step(get)[0] for _ in range(5)]
                wall_p, prof = step(get, profiled=True)
            finally:
                if loader is not None:
                    loader.close()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e6
            median = sorted(walls)[len(walls) // 2]  # the host is shared: steps spread
            log(f"loader: training step with the prefetch loader {'on' if prefetch else 'off'}: "
                f"{median / TRAIN_ACCUM:.4f} s per microbatch (median of 5 steps: "
                + ", ".join(f"{w:.3f}" for w in walls) + f" s); profiled step {wall_p:.3f} s "
                f"wall, device busy {busy:.3f} s (idle share {max(0.0, 1 - busy / wall_p):.3f} "
                f"with the profiler's host cost, {max(0.0, 1 - busy / median):.3f} of the "
                f"median step)")
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    del trainer, state


# --- two ranks on the card: data-parallel training and sharded windows ---------

def _rank_models(seed):
    from insv2v_torch.utils.factory import build_models

    models = build_models(device="cuda", dtype=torch.bfloat16, seed=seed)
    _wake_motion_modules(models["unet"], torch.Generator().manual_seed(seed))
    return models


def _launch_counts():
    return {name: f.launches for name, f in _kernel_fns().items()}


def _train_rows(seed, n):
    """A global batch of n rows (16 frames at 256x256 in [-1, 1], prompt
    ids) and each row's five draws, the same on every rank."""
    import numpy as np

    from insv2v_torch.text.tokenizer import HashTokenizer

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, TRAIN_FRAMES, TRAIN_SIZE, TRAIN_SIZE, 3)
    prompts = ["make it snowy", "turn the dog into a cat"]
    batch = {"input_video": torch.rand(shape, generator=g, device="cuda") * 2 - 1,
             "edited_video": torch.rand(shape, generator=g, device="cuda") * 2 - 1,
             "prompt_ids": np.asarray(HashTokenizer()([prompts[i % 2] for i in range(n)]))}
    lat = (TRAIN_FRAMES, TRAIN_SIZE // 8, TRAIN_SIZE // 8, 4)
    rows = [{"enc_cond": torch.randn(lat, generator=g, device="cuda"),
             "enc_edit": torch.randn(lat, generator=g, device="cuda"),
             "drop": torch.rand(1, generator=g, device="cuda") < 0.1,
             "eps": torch.randn((1,) + lat, generator=g, device="cuda"),
             "t": torch.randint(0, 1000, (1,), generator=g, device="cuda")} for _ in range(n)]
    return batch, rows


def _train_steps(models, group, steps):
    """One Adam and one Adam8bit step (each a fresh trainer over the
    model's motion parameters) on the global batches of ``steps``: with a
    group, each rank's share (accumulation 2 of micro-batch 1); without,
    the whole batch as one microbatch a row. Loss, seconds, launches and
    the update (new - old masters, flat) of each."""
    from insv2v_torch.parallel.dist import (assert_zero_sharded, local_batch_slice,
                                            same_on_all_ranks)
    from insv2v_torch.training.trainer import TrainConfig, Trainer

    out = []
    for kind, (batch, rows) in zip(("adam", "adam8bit"), steps):
        n = len(rows)
        if group is None:
            accum, local, draws = n, batch, rows
        else:
            r, size = group.rank, group.size
            accum = TRAIN_ACCUM
            local = local_batch_slice(batch, accum, r, size)
            draws = [rows[i * size + r] for i in range(accum)]
        trainer = Trainer(models["unet"], models["vae"], models["text_model"],
                          TrainConfig(lr=1e-5, optimizer=kind, accumulate_grad_batches=accum),
                          group=group)
        state = trainer.create_state()
        before = torch.cat([m.reshape(-1) for m in state.params.values()])
        _zero_launches()
        if group is not None:  # the ranks start the timed step together
            group.all_reduce_sum(torch.zeros(1, device="cuda"))
            sent = dict(group.sent)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, local, draws=draws)
        torch.cuda.synchronize()
        entry = {"kind": kind, "loss": metrics["train_loss"],
                 "seconds": time.perf_counter() - t0, "launches": _launch_counts(),
                 "update": torch.cat([m.reshape(-1) for m in state.params.values()]) - before}
        if group is not None:
            entry["bytes"], entry["whole"] = assert_zero_sharded(state.optimizer, group)
            entry["ranks_agree"] = same_on_all_ranks(list(state.params.values()), group)
            entry["sent"] = {k: v - sent.get(k, 0) for k, v in group.sent.items()}
            # the optimizer broadcasts the masters this rank owns
            entry["sent"]["broadcast"] = sum(p.numel() * p.element_size() for g in
                                             state.optimizer.optim.param_groups
                                             for p in g["params"])
        out.append(entry)
        del trainer, state, before
        torch.cuda.empty_cache()
    return out


def _dp_rank(group, models, seed):
    """The data-parallel Adam and Adam8bit steps on a global batch of
    group.size * TRAIN_ACCUM rows; rank 0 then restores the motion parameters
    and runs the one-process steps on the same batches and draws, and
    holds the losses and updates to them. Every rank ends with the motion
    parameters it started from."""
    import dataclasses

    unet = models["unet"]
    unet.cfg = dataclasses.replace(unet.cfg, remat=True)
    n = group.size * TRAIN_ACCUM
    steps = [_train_rows(seed + 10 + k, n) for k in range(2)]
    params = dict(unet.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items() if "motion_modules." in k}

    def restore():
        with torch.no_grad():
            for k, v in start.items():
                params[k].copy_(v)

    with _switches(True, False):
        dp = _train_steps(models, group, steps)
        restore()
        ref = _train_steps(models, None, steps) if group.rank == 0 else None
        restore()
    unet.cfg = dataclasses.replace(unet.cfg, remat=False)
    res = []
    for i, d in enumerate(dp):
        row = {k: v for k, v in d.items() if k != "update"}
        if ref is not None:
            u, w = d["update"], ref[i]["update"]
            row.update(ref_loss=ref[i]["loss"], ref_seconds=ref[i]["seconds"],
                       update_rel=((u - w).norm() / w.norm()).item(),
                       loss_rel=abs(d["loss"] - ref[i]["loss"]) / abs(ref[i]["loss"]))
        res.append(row)
    return res


@contextlib.contextmanager
def _temporal_shapes():
    """Kernel C's launches by (B, P, F, heads, e) inside the block."""
    import collections

    from insv2v_torch.ops import attention

    seen = collections.Counter()
    launch = attention._launch_temporal

    def counted(q, k, v, scale):
        seen[tuple(q.shape)] += 1
        return launch(q, k, v, scale)

    attention._launch_temporal = counted
    try:
        yield seen
    finally:
        attention._launch_temporal = launch


@contextlib.contextmanager
def _planted(fault, group):
    """A fault planted in this rank's process for the block, to show that a
    gate catches it: ``group_norm`` keeps each across-frame GroupNorm's
    statistics to this rank's frames (the moments' all-reduce dropped, in
    ``group_norm`` and in the up blocks' ``group_norm_split_pair`` alike);
    ``ref_delta`` keeps the sampler's sum of the ref frames' deltas to this
    rank's frames (its all-reduce dropped)."""
    from insv2v_torch.ops import norms

    if fault == "group_norm":
        saved = norms._sum_over_ranks
        norms._sum_over_ranks = lambda moments, _group: moments
        try:
            yield
        finally:
            norms._sum_over_ranks = saved
    else:  # the ref-delta sum is the one (B, 1, h, w, C) all-reduce
        reduce = group.all_reduce_sum
        group.all_reduce_sum = lambda t: t if t.ndim == 5 else reduce(t)
        try:
            yield
        finally:
            del group.all_reduce_sum


def _sp_calls(group, unet, g, rel):
    """One full-width UNet call on the edit's 16-frame 256x384 latents,
    frames sharded against unsharded, then the same sharded call with the
    GroupNorm fault planted; on i.i.d. latents, and on latents whose mean
    and spread drift over the frames as a video's do (a frame's latents
    shifted by -0.5 to 0.5 and scaled by 0.75 to 1.25 across the window)."""
    from insv2v_torch.parallel.dist import frame_parallel, shard_range

    f, h, w = 16, EDIT_HEIGHT // 8, EDIT_WIDTH // 8
    ramp = torch.linspace(0, 1, f, device="cuda").reshape(1, f, 1, 1, 1)
    base = torch.randn(1, f, h, w, 8, generator=g, device="cuda")
    ctx = torch.randn(1, 77, 768, generator=g, device="cuda")
    t = torch.tensor([500], device="cuda")
    frames = shard_range(f, group.rank, group.size)
    res = {}
    for name, x in (("iid", base), ("drift", base * (0.75 + 0.5 * ramp) + ramp - 0.5)):
        want = unet(x, t, ctx)

        def sharded():
            with frame_parallel(group):
                return group.all_gather_dim(unet(x[:, frames], t, ctx), 1)

        got = sharded()
        with _planted("group_norm", group):
            faulty = sharded()
        res[name] = {"rel": rel(got, want), "fault_rel": rel(faulty, want),
                     "finite": bool(torch.isfinite(got).all())}
    return res


def _sp_rank(group, models, seed):
    """Frames sharded: the edit's 16-frame 256x384 window (DDIM SP_STEPS,
    text CFG 7.5, video CFG 1.2) and a follow-up window (4 refs,
    noise_correct_step 0.5) against the unsharded windows on the same
    inputs, each again with a fault planted (``_planted``: the first window
    with the GroupNorm fault, the follow-up with the ref-delta one); one
    UNet call sharded against unsharded, and with the GroupNorm fault
    (``_sp_calls``); then one video a rank, sharded by videos, against the
    unsharded batch.
    Relative L2 of the latents, seconds, C's launches by shape and the
    all-to-all bytes this rank sent."""
    from insv2v_torch.diffusion.samplers import sample_video_window
    from insv2v_torch.diffusion.schedules import DiffusionSchedule, make_sampler_tables
    from insv2v_torch.parallel.inference import batch_sharded_window, frame_sharded_window

    unet = models["unet"]
    tables = make_sampler_tables(DiffusionSchedule.create(), SP_STEPS, kind="ddim")
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    h, w = EDIT_HEIGHT // 8, EDIT_WIDTH // 8

    def window_inputs(b):
        lat = torch.randn(b, 16, h, w, 4, generator=g, device="cuda")
        cond = torch.randn(b, 16, h, w, 4, generator=g, device="cuda") * 0.5
        tc = torch.randn(b, 77, 768, generator=g, device="cuda")
        tu = torch.randn(b, 77, 768, generator=g, device="cuda")
        return lat, cond, tc, tu

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()["latent"]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    kw = dict(text_cfg=7.5, img_cfg=1.2)
    res = {}
    group.all_reduce_sum(torch.zeros(1, device="cuda"))  # both ranks here before any timing
    with torch.no_grad():
        lat, cond, tc, tu = window_inputs(1)
        first, _ = timed(lambda: sample_video_window(unet, tables, lat, cond, tc, tu, **kw))
        windows = (("first", {}),
                   ("follow-up", dict(latent_ref=first, num_ref_frames=4,
                                      noise_correct_step=0.5, video_start_index=12)))
        for name, extra in windows:
            want, plain_s = timed(lambda: sample_video_window(unet, tables, lat, cond, tc, tu,
                                                              **kw, **extra))
            sent = group.sent["all_to_all"]
            _zero_launches()
            with _temporal_shapes() as shapes:
                got, sharded_s = timed(lambda: frame_sharded_window(
                    unet, tables, lat, cond, tc, tu, group, **kw, **extra))
            res[name] = {"rel": rel(got, want), "finite": bool(torch.isfinite(got).all()),
                         "sharded_s": sharded_s, "unsharded_s": plain_s,
                         "launches": _launch_counts(),
                         "c_shapes": {str(k): v for k, v in sorted(shapes.items())},
                         "all_to_all_bytes": group.sent["all_to_all"] - sent}
            fault = "group_norm" if name == "first" else "ref_delta"
            with _planted(fault, group):
                faulty = frame_sharded_window(unet, tables, lat, cond, tc, tu, group, **kw,
                                              **extra)["latent"]
            res[name].update(fault=fault, fault_rel=rel(faulty, want))
        res["call"] = _sp_calls(group, unet, g, rel)
        lat, cond, tc, tu = window_inputs(group.size)  # one video a rank
        want, plain_s = timed(lambda: sample_video_window(unet, tables, lat, cond, tc, tu, **kw))
        got, sharded_s = timed(lambda: batch_sharded_window(unet, tables, lat, cond, tc, tu,
                                                            group, **kw))
        res["batch"] = {"rel": rel(got, want), "finite": bool(torch.isfinite(got).all()),
                        "sharded_s": sharded_s, "unsharded_s": plain_s}
    return res


def _rank_main(group, todo, seed):
    """One rank of the dp and sp phases: the full-width models from the
    seed (the same on every rank, checked), then the phases asked for."""
    from insv2v_torch.parallel.dist import same_on_all_ranks

    models = _rank_models(seed)
    if not same_on_all_ranks([p for m in models.values() for p in m.parameters()], group):
        raise AssertionError("the ranks built different weights from one seed")
    out = {"transport": group.describe()}
    if "dp" in todo:
        out["dp"] = _dp_rank(group, models, seed)
    if "sp" in todo:
        out["sp"] = _sp_rank(group, models, seed)
    return out


def phase_ranks(args, todo, smi):
    """dp and/or sp: RANKS processes spawned on the card, joined over gloo."""
    from insv2v_torch.parallel.dist import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_rank_main, RANKS, todo, args.seed, timeout_s=900)
    log(f"ranks: {RANKS} processes on {smi}, {time.perf_counter() - t0:.1f} s in all "
        f"(a rehearsal of two ranks sharing one card: no scaling result)")
    return report_ranks(ranks, todo)


def report_ranks(ranks, todo):
    """Log the ranks' dp and sp results and hold them to their gates;
    returns the launches of each path (rank 0's)."""
    log(ranks[0]["transport"])
    paths = {}
    if "dp" in todo:
        for i, steps in enumerate(zip(*(r["dp"] for r in ranks))):
            head = steps[0]
            for r, st in enumerate(steps):
                log(f"dp rank {r} {st['kind']}: loss {st['loss']:.6f}, {st['seconds']:.3f} s "
                    f"({st['seconds'] / TRAIN_ACCUM:.3f} s per microbatch), optimizer state "
                    f"{st['bytes'][r] / 2 ** 30:.3f} GiB of an unsharded "
                    f"{st['whole'] / 2 ** 30:.3f} GiB (assert_zero_sharded passed), ranks "
                    f"agree {st['ranks_agree']}; sent in the step: "
                    + ", ".join(f"{k} {v / 2 ** 30:.3f} GiB" for k, v in st["sent"].items())
                    + f"; launches A {st['launches']['flash_attention']}, "
                    f"A' {st['launches']['flash_attention_headfold']}, "
                    f"B {st['launches']['fused_geglu_ff']}, "
                    f"C {st['launches']['temporal_attention']}")
            log(f"dp {head['kind']}: {RANKS} ranks vs one process on the global batch of "
                f"{RANKS * TRAIN_ACCUM}: loss {head['loss']:.6f} vs {head['ref_loss']:.6f} "
                f"(rel {head['loss_rel']:.3e}), update rel L2 {head['update_rel']:.3e} "
                f"(tol {SHARD_TOL:g}); one process {head['ref_seconds']:.3f} s for "
                f"{RANKS * TRAIN_ACCUM} microbatches")
            if not (all(st["ranks_agree"] for st in steps) and head["update_rel"] <= SHARD_TOL
                    and head["loss_rel"] <= SHARD_TOL and math.isfinite(head["loss"])):
                raise AssertionError(f"dp {head['kind']}: two ranks disagree with one process")
        paths["dp"] = ranks[0]["dp"][0]["launches"]
        _read_from("dp", paths["dp"], ("flash_attention", "flash_attention_headfold",
                                       "fused_geglu_ff", "temporal_attention"))
    if "sp" in todo:
        for r, out in enumerate(ranks):
            for name in ("first", "follow-up"):
                w = out["sp"][name]
                log(f"sp rank {r} {name} window (16 frames at {EDIT_HEIGHT}x{EDIT_WIDTH}, "
                    f"DDIM {SP_STEPS}, {16 // RANKS} frames a rank): rel L2 vs unsharded "
                    f"{w['rel']:.3e} "
                    f"(tol {SHARD_TOL:g}); {w['sharded_s']:.3f} s sharded, "
                    f"{w['unsharded_s']:.3f} s unsharded; all-to-all sent "
                    f"{w['all_to_all_bytes'] / 2 ** 20:.1f} MiB; kernel C launches by shape "
                    f"{w['c_shapes']}; launches {w['launches']}")
                log(f"sp rank {r} {name} window with the {w['fault']} fault planted: rel L2 "
                    f"vs unsharded {w['fault_rel']:.3e} (tol {SHARD_TOL:g})")
            b = out["sp"]["batch"]
            log(f"sp rank {r} batch-sharded window ({RANKS} videos, 1 a rank): rel L2 vs "
                f"unsharded {b['rel']:.3e}; {b['sharded_s']:.3f} s sharded, "
                f"{b['unsharded_s']:.3f} s unsharded")
            for w in (out["sp"]["first"], out["sp"]["follow-up"], b):
                if not (w["finite"] and w["rel"] <= SHARD_TOL):
                    raise AssertionError(f"sp rank {r}: a sharded window disagrees: {w['rel']}")
            for name, c in out["sp"]["call"].items():
                log(f"sp rank {r} one UNet call ({name} latents, 16 frames at "
                    f"{EDIT_HEIGHT}x{EDIT_WIDTH}, {16 // RANKS} frames a rank): rel L2 vs "
                    f"unsharded {c['rel']:.3e} (tol {SP_CALL_TOL:g}); with the group_norm "
                    f"fault planted {c['fault_rel']:.3e}")
                if not (c["finite"] and c["rel"] <= SP_CALL_TOL):
                    raise AssertionError(f"sp rank {r}: the sharded UNet call disagrees: "
                                         f"{c['rel']}")
            if not out["sp"]["call"]["drift"]["fault_rel"] > SP_CALL_TOL:
                raise AssertionError(f"sp rank {r}: the planted GroupNorm fault passed the "
                                     f"gate: {out['sp']['call']['drift']['fault_rel']}")
        paths["sp"] = ranks[0]["sp"]["first"]["launches"]
        _read_from("sp", paths["sp"], ("flash_attention", "fused_geglu_ff",
                                       "temporal_attention"))
    return paths


def _read_from(path, counts, must):
    missing = [k for k in must if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")


def _write_ptp(root, n_samples=2):
    """Prompt-to-prompt sample folders: 16 frame pairs at 256x256 (JPEG)."""
    import cv2
    import numpy as np

    rs = np.random.RandomState(0)
    for s in range(n_samples):
        d = os.path.join(root, f"sample_{s:03d}", "image")
        os.makedirs(d)
        for which in (0, 1):
            for i in range(TRAIN_FRAMES):
                img = (rs.rand(TRAIN_SIZE, TRAIN_SIZE, 3) * 255).astype(np.uint8)
                cv2.imwrite(os.path.join(d, f"1_{which}_{i:04d}.jpg"), img)
        with open(os.path.join(root, f"sample_{s:03d}", "metadata.jsonl"), "w") as f:
            f.write(json.dumps({"seed": 1, "sim_0": 0.5, "sim_1": 0.5, "sim_dir": 0.5,
                                "sim_image": 0.9}) + "\n")
        with open(os.path.join(root, f"sample_{s:03d}", "prompt.json"), "w") as f:
            json.dump({"input": "a cat", "output": "a dog", "edit": "make it a dog"}, f)


def phase_frozen_f32(args):
    """The train CLI's ``--frozen-f32`` arithmetic against bf16-stored
    models: one microbatch (16 frames at 256x256, kernel A' and remat on)
    through the trainer with the models stored in float32 and computed
    under bf16 autocast, and with the same weights stored in bf16. The loss
    and the motion gradients are held to each other at GRAD_TOL relative
    L2 (the bf16 gate); the autocast run must launch A', B and C."""
    import copy
    import dataclasses

    from insv2v_torch.training.trainer import TrainConfig, Trainer
    from insv2v_torch.utils.factory import build_models

    f32 = build_models(device="cuda", dtype=torch.float32, seed=args.seed)
    _wake_motion_modules(f32["unet"], torch.Generator().manual_seed(args.seed))
    bf16 = {k: copy.deepcopy(m).to(torch.bfloat16) for k, m in f32.items()}
    batch, rows = _train_rows(args.seed + 40, 1)
    out = {}
    with _switches(True, False):
        for name, models, dtype in (("f32", f32, "bfloat16"), ("bf16", bf16, None)):
            unet = models["unet"]
            unet.cfg = dataclasses.replace(unet.cfg, remat=True)
            trainer = Trainer(unet, models["vae"], models["text_model"],
                              TrainConfig(compute_dtype=dtype))
            state = trainer.create_state()
            _zero_launches()
            t0 = time.perf_counter()
            loss, grads = trainer.accumulate_grads(state, batch, draws=rows)
            torch.cuda.synchronize()
            out[name] = {"loss": float(loss), "seconds": time.perf_counter() - t0,
                         "grad": torch.cat([g.reshape(-1) for g in grads]),
                         "launches": _launch_counts()}
            del trainer, state, grads
    del f32, bf16
    a, b = out["f32"], out["bf16"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    grad_rel = ((a["grad"] - b["grad"]).norm() / b["grad"].norm()).item()
    log(f"frozen-f32: one microbatch (16 frames at {TRAIN_SIZE}x{TRAIN_SIZE}) with the models "
        f"stored in float32 under bf16 autocast vs stored in bf16: loss {a['loss']:.6f} vs "
        f"{b['loss']:.6f} (rel {loss_rel:.3e}), motion gradients rel L2 {grad_rel:.3e} (tol "
        f"{GRAD_TOL:g}); {a['seconds']:.3f} / {b['seconds']:.3f} s (first call of each); "
        f"launches under autocast {a['launches']}")
    del out
    torch.cuda.empty_cache()
    if not (math.isfinite(a["loss"]) and loss_rel <= GRAD_TOL and grad_rel <= GRAD_TOL):
        raise AssertionError("the float32-stored models under autocast disagree with the "
                             "bf16-stored ones")
    _read_from("frozen-f32", a["launches"], ("flash_attention_headfold", "fused_geglu_ff",
                                              "temporal_attention"))


def phase_dp_cli(args):
    """``apps/train.py`` as two processes on the card (``--coordinator``,
    gloo, ``--frozen-f32``, the prefetch loader), 2 steps of accumulation
    2 on a generated data folder: one metrics.jsonl and one checkpoint,
    both from rank 0, the checkpoint's optimizer state whole; the ranks'
    motion masters equal (the CLI checks and rank 0 says so)."""
    import socket
    import tempfile

    import yaml

    from insv2v_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        _write_ptp(os.path.join(tmp, "ptp"))
        cfg = load_config(CONFIG)
        cfg["expt_dir"], cfg["expt_name"] = os.path.join(tmp, "experiments"), "dp"
        cfg["trainer"].update(accumulate_grad_batches=TRAIN_ACCUM, micro_batch_size=1,
                              val_every=0, checkpoint_every=1000)
        cfg["data"]["train"]["params"]["root_dirs"] = [os.path.join(tmp, "ptp")]
        cfg_path = os.path.join(tmp, "dp.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "insv2v_torch.apps.train", "--config", cfg_path,
             "--allow-random-weights", "--max-steps", "2", "--frozen-f32", "--seed",
             str(args.seed), "--coordinator", f"127.0.0.1:{port}", "--num-processes",
             str(RANKS), "--process-id", str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            lines = [ln for ln in out.splitlines() if "socket.cpp" not in ln]
            log(f"dp cli rank {r} (rc {p.returncode}):\n  " + "\n  ".join(lines[-12:]))
            if p.returncode != 0:
                raise AssertionError(f"train CLI rank {r} failed with rc {p.returncode}")
        expt = os.path.join(tmp, "experiments", "dp")
        files = sorted(os.listdir(expt))
        records = [json.loads(ln) for ln in open(os.path.join(expt, "metrics.jsonl"))]
        saved = torch.load(os.path.join(expt, "step_00000002.pt"), map_location="cpu",
                           weights_only=True, mmap=True)
        n = len(saved["params"])
        whole = sorted(saved["optimizer"]["state"]) == list(range(n))
        log(f"dp cli: {RANKS} ranks, 2 steps, --frozen-f32: {wall:.1f} s wall; files {files}; "
            f"metrics steps {[rec['step'] for rec in records]}, losses "
            f"{[round(rec['train_loss'], 6) for rec in records]}; CUDA-graph captures and "
            f"replays so far "
            f"{[(rec.get('graph_captures'), rec.get('graph_replays')) for rec in records]}; "
            f"checkpoint of {n} masters with the whole optimizer state: {whole}")
        ok = (files == ["metrics.jsonl", "step_00000002.pt"]
              and [rec["step"] for rec in records] == [1, 2]
              and all(math.isfinite(rec["train_loss"]) for rec in records) and whole
              and f"motion masters equal on {RANKS} ranks" in outs[0]
              and "checkpointed" in outs[0]
              and not any("checkpointed" in out or "step 1:" in out for out in outs[1:]))
        if not ok:
            raise AssertionError("the two-process train CLI did not write from rank 0 alone")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="env,build,parity,unet,ckpt,edit,flow,profile,split,"
                                      "variants,grad,train,loader,loveu,demo,t5,datagen,dp,sp")
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
    if {"unet", "ckpt", "edit", "flow", "profile", "split", "variants", "grad", "train",
            "loader"} & set(phases):
        from insv2v_torch.utils.factory import build_models

        t0 = time.perf_counter()
        models = build_models(device="cuda", dtype=torch.bfloat16, seed=args.seed)
        _wake_motion_modules(models["unet"], cpu_gen)
        n = sum(p.numel() for m in models.values() for p in m.parameters())
        log(f"models: {n / 1e6:.1f} M parameters, bf16 on the GPU, built in "
            f"{time.perf_counter() - t0:.1f} s")
        if "unet" in phases:
            phase_unet(models, cpu_gen)
        if "ckpt" in phases:
            paths["ckpt"] = phase_ckpt(models, args, cpu_gen)
        plain_step = None
        if "edit" in phases:
            paths["edit"], plain_step = phase_edit(models, args, cpu_gen)
        if "flow" in phases:
            paths["flow"] = phase_flow(models, args, cpu_gen, plain_step)
        if "profile" in phases:
            phase_profile(models, cpu_gen)
        if "split" in phases:  # before the trainer pins the UNet to the concat path
            paths["split"] = phase_split(models, cpu_gen)
        if "variants" in phases:
            paths["variants"] = phase_variants(models, cpu_gen)
        if "grad" in phases:
            phase_grad(models, cpu_gen)
        if "train" in phases:  # it and the loader train the motion weights
            paths["train"] = phase_train(models, args, gen)
        if "loader" in phases:
            phase_loader(models, args)
        del models
    if "loveu" in phases:  # the runner builds its own models
        paths["loveu"] = phase_loveu(cpu_gen)
    if "demo" in phases:  # so does the demo's editor
        paths["demo"] = phase_demo(args, cpu_gen)
    if "t5" in phases:
        phase_t5(args, cpu_gen)
    if "datagen" in phases:  # the generator builds its own models
        paths["datagen"] = phase_datagen(args, cpu_gen)
    if "dp" in phases:  # one process, then the train CLI as two
        phase_frozen_f32(args)
        phase_dp_cli(args)
    ranked = [p for p in ("dp", "sp") if p in phases]
    if ranked:  # spawned ranks build their own models
        paths.update(phase_ranks(args, ranked, smi))
    # each kernel's launches on the path it belongs to: A, B, C, E the
    # edit's (their first slice), A' training's, D the variant edit window's
    home = {"flash_attention": "edit", "fused_geglu_ff": "edit", "temporal_attention": "edit",
            "flash_attention_headfold": "train", "fused_layer_norm": "variants",
            "fused_group_norm": "edit"}
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
