#!/usr/bin/env python3
"""Kernel A of the PyTorch port (``flash_attention``, and A' with
``headfold``): registers and spills of every compiled variant of A and of
kernel C, then A and A' against their float32 twin and timed, on one GPU.

    python3 tools/torch_flash_probe.py [B,H,S,D ...]

Builds ``csrc/flash_attn.cu`` and ``csrc/temporal_attn.cu`` with ptxas'
report (``-Xptxas -v``) and prints, for each kernel it compiles, its
registers, stack and spill bytes;
then, at each shape given (default: ``chip_smoke.DATAGEN_FLASH_SHAPES``,
ModelScope's d = 64 self-attention), A and A' on seeded bf16 inputs: max
|error| against the twin and the device time per call from torch.profiler
over back-to-back calls (``chip_smoke.device_ms``), with the grid the
launcher chooses.
"""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _kernel_name(mangled: str) -> str:
    """flash_fwd_kernel<DP, HEADFOLD, NWG, SPLIT>, flash_fwd64_kernel<HEADFOLD>,
    flash_fwd_wide_kernel or temporal_attn_kernel<FP, EP>."""
    m = re.search(r"(flash_fwd_kernel|flash_fwd64_kernel|flash_fwd_wide_kernel|"
                  r"temporal_attn_kernel)(I(?:L[bi]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[bi](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def main(argv):
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from insv2v_torch.kernels import build
    from insv2v_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for source in ("flash_attn", "temporal_attn"):
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [build._nvcc(), *build._FLAGS, "-Xptxas", "-v", "-o",
                   os.path.join(tmp, "lib.so"), str(build.CSRC / f"{source}.cu")]
            out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        kernel = None
        for line in (out.stdout + out.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _kernel_name(m.group(1))
            elif kernel and ("spill" in line or "registers" in line):
                print(f"ptxas {kernel}: {line.strip()}")
    shapes = ([tuple(int(x) for x in a.split(",")) for a in argv] if argv
              else cs.DATAGEN_FLASH_SHAPES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in shapes:
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        ref = A.flash_attention_reference(q.float(), k.float(), v.float())
        for hf in (False, True):
            err = (A.flash_attention(q, k, v, headfold=hf).float() - ref).abs().max().item()
            ms, clock = cs.device_ms(lambda: A.flash_attention(q, k, v, headfold=hf), 20)
            print(f"{'A′' if hf else 'A '} {shape}: max_abs_err {err:.3e}, {ms:.4f} ms ({clock}), "
                  f"grid {A.flash_grid(*shape, headfold=hf)}")


if __name__ == "__main__":
    main(sys.argv[1:])
