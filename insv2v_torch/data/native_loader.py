"""The host data path: native batch-assembly loops and a prefetching loader.

Counterpart of ``data/native_loader.py`` in the JAX package, over the
port's own copy of its C++ source (``csrc/batch_ops.cpp``: the same loops,
threaded with ``std::thread``), bound with ctypes:

  * ``normalize_frames``: uint8 frames -> float32 in [-1, 1];
  * ``resize_normalize``: bilinear resize (half-pixel centres) + normalize;
  * ``crop_resize_normalize``: a per-frame crop resized back to the frame
    size + normalize (the motion augmentation's inner loop);
  * ``PrefetchLoader``: a worker thread that assembles the next batches
    while the device runs the current step.

Each op has a plain numpy twin (``*_reference``) with the same float32
arithmetic. ``native=True`` (the default) builds the library with g++ on
first use into ``insv2v_torch/_build/`` (named by a hash of the source and
flags) and raises if that fails: no silent fallback. ``native=False``
runs the twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from insv2v_torch.utils.tracing import span

__all__ = ["SOURCE", "library_path", "load", "normalize_frames", "resize_normalize",
           "crop_resize_normalize", "normalize_frames_reference",
           "resize_normalize_reference", "crop_resize_normalize_reference",
           "PrefetchLoader"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "batch_ops.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_F32 = np.float32
_INV = _F32(1.0) / _F32(127.5)  # the C++ (1.0f / 127.5f)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libbatch_ops-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The ctypes handle of the library, compiled first if needed; raises
    RuntimeError with the compiler's output if the build fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            cmd = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", str(tmp), str(SOURCE),
                   "-lpthread"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"native loader: cannot run {cmd[0]}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"native loader: {' '.join(cmd)} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
        i32p, c_int = ctypes.POINTER(ctypes.c_int), ctypes.c_int
        lib.normalize_frames.argtypes = [u8p] + [c_int] * 4 + [f32p, c_int]
        lib.resize_normalize.argtypes = [u8p] + [c_int] * 6 + [f32p, c_int]
        lib.crop_resize_normalize.argtypes = [u8p] + [c_int] * 4 + [f32p, f32p, i32p, i32p,
                                                                    f32p, c_int]
        for fn in (lib.normalize_frames, lib.resize_normalize, lib.crop_resize_normalize):
            fn.restype = None
        _LIB = lib
        return lib


def _threads() -> int:
    return max(1, (os.cpu_count() or 2) - 1)


def _frames(frames_u8) -> np.ndarray:
    x = np.ascontiguousarray(frames_u8)
    if x.dtype != np.uint8 or x.ndim != 4:
        raise TypeError(f"expected uint8 frames (N, H, W, C), got {x.dtype} {x.shape}")
    return x


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# --- plain twins --------------------------------------------------------------

def normalize_frames_reference(frames_u8) -> np.ndarray:
    return _frames(frames_u8).astype(_F32) * _INV - _F32(1.0)


def _bilinear_normalize(src: np.ndarray, fy: np.ndarray, fx: np.ndarray) -> np.ndarray:
    """The C++ ``sample_bilinear`` at rows ``fy`` (N, OH) and columns ``fx``
    (N, OW), float32, then normalized: (N, OH, OW, C)."""
    n, h, w, _ = src.shape
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    ty, tx = fy - y0.astype(_F32), fx - x0.astype(_F32)
    y1, x1 = np.clip(y0 + 1, 0, h - 1), np.clip(x0 + 1, 0, w - 1)
    y0, x0 = np.clip(y0, 0, h - 1), np.clip(x0, 0, w - 1)
    i = np.arange(n)[:, None, None]
    at = lambda y, x: src[i, y[:, :, None], x[:, None, :]].astype(_F32)
    tx, ty = tx[:, None, :, None], ty[:, :, None, None]
    top = at(y0, x0) + (at(y0, x1) - at(y0, x0)) * tx
    bot = at(y1, x0) + (at(y1, x1) - at(y1, x0)) * tx
    return (top + (bot - top) * ty) * _INV - _F32(1.0)


def resize_normalize_reference(frames_u8, oh: int, ow: int) -> np.ndarray:
    src = _frames(frames_u8)
    n, h, w, _ = src.shape
    sy, sx = _F32(h) / _F32(oh), _F32(w) / _F32(ow)
    fy = (np.arange(oh, dtype=_F32) + _F32(0.5)) * sy - _F32(0.5)
    fx = (np.arange(ow, dtype=_F32) + _F32(0.5)) * sx - _F32(0.5)
    return _bilinear_normalize(src, np.broadcast_to(fy, (n, oh)), np.broadcast_to(fx, (n, ow)))


def _crop_args(n, cx, cy, crop_h, crop_w):
    args = (np.ascontiguousarray(cx, _F32), np.ascontiguousarray(cy, _F32),
            np.ascontiguousarray(crop_h, np.int32), np.ascontiguousarray(crop_w, np.int32))
    if any(a.shape != (n,) for a in args):
        raise ValueError(f"crop centres and sizes must each hold {n} values")
    return args


def crop_resize_normalize_reference(frames_u8, cx, cy, crop_h, crop_w) -> np.ndarray:
    src = _frames(frames_u8)
    n, h, w, _ = src.shape
    cx, cy, crop_h, crop_w = _crop_args(n, cx, cy, crop_h, crop_w)
    ch, cw = crop_h.astype(_F32), crop_w.astype(_F32)
    y_start, x_start = cy - ch * _F32(0.5), cx - cw * _F32(0.5)
    sy, sx = ch / _F32(h), cw / _F32(w)
    fy = y_start[:, None] + (np.arange(h, dtype=_F32) + _F32(0.5)) * sy[:, None] - _F32(0.5)
    fx = x_start[:, None] + (np.arange(w, dtype=_F32) + _F32(0.5)) * sx[:, None] - _F32(0.5)
    return _bilinear_normalize(src, fy, fx)


# --- the native ops -----------------------------------------------------------

def normalize_frames(frames_u8, native: bool = True) -> np.ndarray:
    """(N, H, W, C) uint8 -> float32 in [-1, 1]."""
    if not native:
        return normalize_frames_reference(frames_u8)
    src = _frames(frames_u8)
    out = np.empty(src.shape, _F32)
    load().normalize_frames(_ptr(src, ctypes.c_uint8), *src.shape,
                            _ptr(out, ctypes.c_float), _threads())
    return out


def resize_normalize(frames_u8, oh: int, ow: int, native: bool = True) -> np.ndarray:
    """(N, H, W, C) uint8 -> float32 (N, oh, ow, C) in [-1, 1], bilinear
    with half-pixel centres (cv2.INTER_LINEAR's convention)."""
    if not native:
        return resize_normalize_reference(frames_u8, oh, ow)
    src = _frames(frames_u8)
    n, h, w, c = src.shape
    out = np.empty((n, oh, ow, c), _F32)
    load().resize_normalize(_ptr(src, ctypes.c_uint8), n, h, w, c, oh, ow,
                            _ptr(out, ctypes.c_float), _threads())
    return out


def crop_resize_normalize(frames_u8, cx, cy, crop_h, crop_w, native: bool = True) -> np.ndarray:
    """Per frame i: the crop of ``crop_h[i] x crop_w[i]`` centred at
    (``cx[i]``, ``cy[i]``), resized back to (H, W) and normalized."""
    if not native:
        return crop_resize_normalize_reference(frames_u8, cx, cy, crop_h, crop_w)
    src = _frames(frames_u8)
    n, h, w, c = src.shape
    cx, cy, crop_h, crop_w = _crop_args(n, cx, cy, crop_h, crop_w)
    out = np.empty(src.shape, _F32)
    load().crop_resize_normalize(
        _ptr(src, ctypes.c_uint8), n, h, w, c, _ptr(cx, ctypes.c_float),
        _ptr(cy, ctypes.c_float), _ptr(crop_h, ctypes.c_int), _ptr(crop_w, ctypes.c_int),
        _ptr(out, ctypes.c_float), _threads())
    return out


# --- prefetching -------------------------------------------------------------

_END = object()


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


class PrefetchLoader:
    """Iterate ``batch_fn()`` with up to ``depth`` batches made ahead by a
    worker thread. ``StopIteration`` from ``batch_fn`` ends the iteration;
    any other exception there is raised to the consumer at the batch it
    would have made. ``close()`` stops the worker and drains the queue;
    the loader is also a context manager that closes on exit. Spans: the
    worker's ``loader.produce`` around each ``batch_fn()`` and the
    consumer's ``loader.wait`` around each take, both with the batch's
    index as their unit."""

    def __init__(self, batch_fn: Callable[[], object], depth: int = 2):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._taken = 0
        self._thread = threading.Thread(target=self._worker, name="PrefetchLoader",
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        for i in itertools.count():
            if self._stop.is_set():
                return
            try:
                with span("loader.produce", unit=i):
                    batch = self._fn()
            except StopIteration:
                self._put(_END)
                return
            except Exception as e:  # reaches the consumer in __next__
                self._put(_Failed(e))
                return
            if not self._put(batch):
                return

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with span("loader.wait", unit=self._taken):
            item = self._q.get()
        self._taken += 1
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, _Failed):
            self._done = True
            raise item.error
        return item

    def close(self) -> None:
        self._stop.set()
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
