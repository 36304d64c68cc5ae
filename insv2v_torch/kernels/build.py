"""Build the hand-written CUDA kernels of ``insv2v_torch/csrc`` and bind
them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``insv2v_torch/_build``
on first use. The file name carries a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the port, and this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build_all", "load", "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attn", "geglu_ff", "temporal_attn", "layer_norm", "group_norm")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, all at
    once. Returns the seconds each build took (0.0 when reused); raises
    with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = 0.0
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    errors = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        msg = load(name).error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status} ({msg})")
