#!/usr/bin/env python3
"""Kernel B of the PyTorch port (``fused_geglu_ff``), timed tree against
tree on one GPU.

    python3 tools/torch_ff_compare.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (a directory that
holds ``insv2v_torch``). The trees run in the order given, each in a
subprocess of its own that builds that tree's kernels and times its
``fused_geglu_ff`` at every shape of ``chip_smoke.FF_SHAPES`` (this
checkout's) on the same seeded inputs: device time per call from
torch.profiler over back-to-back calls (``chip_smoke.device_ms``), and
each kernel's share of it. Name a
tree twice to time it twice, e.g. ``old . . old``. Prints one line per
tree and shape, then one JSON line with every time.
"""

from __future__ import annotations

import importlib.util
import json
import re
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_kernel(fn, iters: int):
    """(kernel name, device ms per call) of each kernel ``fn`` launches,
    from one torch.profiler trace of ``iters`` back-to-back calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    name = lambda key: (re.search(r"(\w+(<[^>]*>)?)\(", key) or re.search(r"(.{1,40})", key))[1]
    return [(name(e.key), e.self_device_time_total / 1e3 / iters)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def time_tree(tree: str) -> dict:
    """Times ``tree``'s kernel B at every FF shape; runs in the subprocess."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from insv2v_torch.ops.fused_ff import fused_geglu_ff

    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda") * scale
                                 ).to(torch.bfloat16)
    times = {}
    for n, c in cs.FF_SHAPES:
        inner = 4 * c
        args = (rnd(n, c), (1.0 + 0.1 * rnd(c).float()).to(torch.bfloat16), rnd(c, scale=0.1),
                rnd(2 * inner, c, scale=c ** -0.5), rnd(2 * inner, scale=0.1),
                rnd(c, inner, scale=inner ** -0.5), rnd(c, scale=0.1))
        ms, clock = cs.device_ms(lambda: fused_geglu_ff(*args), 20)
        times[f"{n}x{c}"] = ms
        print(f"{tree}: fused_geglu_ff ({n}, {c}) {ms:.4f} ms ({clock}); by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel(lambda: fused_geglu_ff(*args), 20)),
              flush=True)
    return times


def main():
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_tree(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if proc.returncode != 0:
            print(f"{tree}: failed with exit code {proc.returncode}", file=sys.stderr)
            return 1
        runs.append({"tree": tree, "ms": json.loads(lines[-1])})
    print(json.dumps({"fused_geglu_ff": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
