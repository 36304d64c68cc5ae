#!/usr/bin/env python3
"""Kernels A, A' and C of the PyTorch port (``flash_attention``,
``flash_attention_headfold``, ``temporal_attention``), timed tree against
tree on one GPU.

    python3 tools/torch_attn_compare.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (a directory that
holds ``insv2v_torch``). The trees run in the order given, each in a
subprocess of its own that builds that tree's kernels and times them on
the same seeded bf16 inputs at this checkout's ``chip_smoke`` shapes: A and
A' at ``DATAGEN_FLASH_SHAPES`` (d = 64), A at the edit's and LOVEU's UNet
shapes (d = 40 and 80), and C at every ``TEMPORAL_SHAPES`` shape. Each row
has the device time per call from torch.profiler over back-to-back calls
(``chip_smoke.device_ms``), the max |error| against the float32 twin, the
grid the tree's launcher reports, and one ``F.scaled_dot_product_attention``
call on the same inputs timed in the same process (the yardstick; C's as
(B*P*heads, 1, F, e)). Name a tree twice to time it twice, e.g.
``old . . old``. Prints one line per tree and shape, the card's name and
power limit, then one JSON line with every number.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel A at d = 40/80: the edit's and the LOVEU runner's UNet attn1
NARROW_SHAPES = [(48, 8, 1536, 40), (48, 8, 384, 80), (48, 8, 2304, 40), (48, 8, 576, 80)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str) -> dict:
    """Times ``tree``'s kernels A, A' and C; runs in the subprocess."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.abspath(tree))
    from insv2v_torch.ops import attention as A

    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def row(kernel, shape, out, ref, fn, lib, bms, grid):
        err = (out.float() - ref).abs().max().item()
        ms, clock = cs.device_ms(fn, 20)
        lib_ms, _ = cs.device_ms(lib, 20)
        rows.append({"kernel": kernel, "shape": list(shape), "ms": ms, "clock": clock,
                     "sdpa_ms": lib_ms, "bound_ms": bms, "max_abs_err": err, "grid": grid})
        print(f"{tree}: {kernel} {shape}: {ms:.4f} ms ({clock}), SDPA {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({100 * bms / ms:.1f} %), max_abs_err {err:.3e}, grid {grid}",
              flush=True)

    flash = [(s, False) for s in cs.DATAGEN_FLASH_SHAPES + NARROW_SHAPES]
    flash += [(s, True) for s in cs.DATAGEN_FLASH_SHAPES]
    for shape, hf in flash:
        b, h, s, d = shape
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        ref = A.flash_attention_reference(q.float(), k.float(), v.float())
        bms, _ = cs.bound(4.0 * b * h * s * s * d, 2.0 * 4 * b * h * s * d)
        row("flash_attention_headfold" if hf else "flash_attention", shape,
            A.flash_attention(q, k, v, headfold=hf), ref,
            lambda: A.flash_attention(q, k, v, headfold=hf),
            lambda: F.scaled_dot_product_attention(q, k, v), bms,
            A.flash_grid(*shape, headfold=hf))
    for shape in cs.TEMPORAL_SHAPES:
        b, p, f, h, e = shape
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        ref = A.temporal_attention_reference(q.float(), k.float(), v.float())
        sd = lambda t: t.permute(0, 1, 3, 2, 4).reshape(b * p * h, 1, f, e)
        qs, ks, vs = sd(q), sd(k), sd(v)
        bms, _ = cs.bound(4.0 * b * p * h * f * f * e, 2.0 * 4 * b * p * f * h * e)
        row("temporal_attention", shape, A.temporal_attention(q, k, v), ref,
            lambda: A.temporal_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(qs, ks, vs), bms, A.temporal_grid(*shape))
    return {"rows": rows}


def main():
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(time_tree(sys.argv[2])))
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
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
        runs.append({"tree": tree, **json.loads(lines[-1])})
    print(smi)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
