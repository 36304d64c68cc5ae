"""The port's host data path (insv2v_torch.data.native_loader): the three
native batch ops against the JAX package's native_loader on the same uint8
inputs and against the port's plain numpy twins, the PrefetchLoader, and
where the library is built.

Tolerances: normalize_frames 1e-6, resize_normalize and
crop_resize_normalize 1e-5 against the JAX package (both sides build the
same C++ loops); the twins at tests/test_native_loader.py's tolerances
(1e-6 normalize, 2e-2 resize against cv2's fixed point, 1e-5 crop)."""

import hashlib
import os
import shutil
import time

import numpy as np
import pytest
import torch

from insv2v_tpu.data import native_loader as jl
from insv2v_torch.data import native_loader as nl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs, as the other
    port test modules do: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native_loader with its library built from a copy
    of native/batch_ops.cpp in a temporary directory (its own build code
    and flags), so this module neither writes native/ nor races another
    test's build of native/libbatch_ops.so."""
    src_dir = tmp_path_factory.mktemp("jax_native")
    shutil.copy(os.path.join(NATIVE, "batch_ops.cpp"), src_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "_SRC_DIR", str(src_dir))
        mp.setattr(jl, "_LIB", None)
        mp.setattr(jl, "_TRIED", False)
        assert jl.native_available(), "the JAX package's native build failed"
        yield jl


def frames(n=6, h=24, w=20, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, c), dtype=np.uint8)


def crops(n, h, w, seed=1):
    """Crops inside the frame: there the port's native op and the JAX
    package's build the same bytes (the JAX package's C++ loop reads out of
    bounds for a window past the frame's left or top edge)."""
    rs = np.random.RandomState(seed)
    ch = rs.randint(h // 2, h + 1, n).astype(np.int32)
    cw = rs.randint(w // 2, w + 1, n).astype(np.int32)
    cx = (cw / 2 + rs.rand(n) * (w - cw)).astype(np.float32)
    cy = (ch / 2 + rs.rand(n) * (h - ch)).astype(np.float32)
    return cx, cy, ch, cw


# --- against the JAX package -------------------------------------------------

def test_normalize_frames_matches_jax(jax_native):
    u8 = frames()
    np.testing.assert_allclose(nl.normalize_frames(u8), jax_native.normalize_frames(u8),
                               atol=1e-6)


@pytest.mark.parametrize("oh,ow", [(8, 30), (48, 13)])
def test_resize_normalize_matches_jax(jax_native, oh, ow):
    u8 = frames(seed=2)
    np.testing.assert_allclose(nl.resize_normalize(u8, oh, ow),
                               jax_native.resize_normalize(u8, oh, ow), atol=1e-5)


def test_crop_resize_normalize_matches_jax(jax_native):
    u8 = frames(n=5, h=32, w=28, seed=3)
    args = crops(5, 32, 28)
    np.testing.assert_allclose(nl.crop_resize_normalize(u8, *args),
                               jax_native.crop_resize_normalize(u8, *args), atol=1e-5)


# --- against the plain twins -------------------------------------------------

@pytest.mark.parametrize("op,tol", [("normalize", 1e-6), ("resize", 2e-2), ("crop", 1e-5)])
def test_native_ops_match_plain_twins(op, tol):
    u8 = frames(n=4, h=30, w=26, seed=4)
    call = {"normalize": lambda native: nl.normalize_frames(u8, native=native),
            "resize": lambda native: nl.resize_normalize(u8, 17, 41, native=native),
            "crop": lambda native: nl.crop_resize_normalize(u8, *crops(4, 30, 26),
                                                            native=native)}[op]
    got, want = call(True), call(False)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("edge", ["left", "top", "both"])
def test_off_frame_crops_match_the_twin(edge):
    """Crop windows reaching several pixels past the frame's left or top
    edge: every bilinear neighbour is clamped into the frame, in the native
    op as in its twin (1e-5)."""
    n, h, w = 4, 30, 26
    u8 = frames(n=n, h=h, w=w, seed=7)
    rs = np.random.RandomState(8)
    ch = rs.randint(h // 2, h + 1, n).astype(np.int32)
    cw = rs.randint(w // 2, w + 1, n).astype(np.int32)
    cx = (cw / 2 + rs.rand(n) * (w - cw)).astype(np.float32)
    cy = (ch / 2 + rs.rand(n) * (h - ch)).astype(np.float32)
    if edge in ("left", "both"):  # windows starting 3 to 9 pixels left of the frame
        cx = (cw / 2 - rs.uniform(3, 9, n)).astype(np.float32)
    if edge in ("top", "both"):
        cy = (ch / 2 - rs.uniform(3, 9, n)).astype(np.float32)
    got = nl.crop_resize_normalize(u8, cx, cy, ch, cw)
    want = nl.crop_resize_normalize(u8, cx, cy, ch, cw, native=False)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_twins_follow_cv2_and_the_identity_crop():
    """The twins against references of their own: cv2's bilinear resize
    (fixed point, 2e-2) and an identity crop (the frames, 1e-5)."""
    import cv2

    u8 = frames(n=2, h=16, w=12, seed=5)
    want = np.stack([cv2.resize(f, (20, 8), interpolation=cv2.INTER_LINEAR) for f in u8])
    np.testing.assert_allclose(nl.resize_normalize_reference(u8, 8, 20),
                               want.astype(np.float32) / 127.5 - 1.0, atol=2e-2)
    n, h, w = 3, 16, 16
    u8 = frames(n=n, h=h, w=w, seed=6)
    got = nl.crop_resize_normalize_reference(u8, np.full(n, w / 2), np.full(n, h / 2),
                                             np.full(n, h), np.full(n, w))
    np.testing.assert_allclose(got, u8.astype(np.float32) / 127.5 - 1.0, atol=1e-5)


def test_ops_reject_non_uint8_frames():
    with pytest.raises(TypeError, match="uint8"):
        nl.normalize_frames(np.zeros((1, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="4 values"):
        nl.crop_resize_normalize(frames(n=4), np.zeros(3), np.zeros(4), np.ones(4),
                                 np.ones(4))


# --- the build --------------------------------------------------------------

def _snapshot(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        with open(path, "rb") as f:
            out[name] = (os.path.getmtime(path), hashlib.sha256(f.read()).hexdigest())
    return out


def test_build_goes_to_the_port_build_dir_and_leaves_native_untouched(tmp_path, monkeypatch):
    assert nl.library_path().parent == nl.BUILD_DIR
    assert nl.BUILD_DIR == nl.SOURCE.parents[1] / "_build"
    before = _snapshot(NATIVE)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nl, "_LIB", None)
    nl.load()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [nl.library_path().name]
    assert _snapshot(NATIVE) == before


def test_failed_build_raises_and_the_plain_path_needs_none(tmp_path, monkeypatch):
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nl, "_LIB", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    u8 = frames(n=1)
    with pytest.raises(RuntimeError, match="native loader"):
        nl.normalize_frames(u8)
    np.testing.assert_allclose(nl.normalize_frames(u8, native=False),
                               u8.astype(np.float32) / 127.5 - 1.0, atol=1e-6)


# --- PrefetchLoader ------------------------------------------------------------

def test_prefetch_loader_round_trip():
    made = []

    def make():
        if len(made) >= 3:
            raise StopIteration
        made.append(len(made))
        return {"x": np.full(2, len(made))}

    with nl.PrefetchLoader(make, depth=1) as loader:
        got = [b["x"][0] for b in loader]
        assert got == [1, 2, 3]
        with pytest.raises(StopIteration):
            next(loader)


def test_prefetch_loader_raises_the_worker_error():
    n = []

    def make():
        n.append(1)
        if len(n) == 3:
            raise ValueError("bad sample 3")
        return len(n)

    loader = nl.PrefetchLoader(make, depth=2)
    assert [next(loader), next(loader)] == [1, 2]
    with pytest.raises(ValueError, match="bad sample 3"):
        next(loader)
    loader.close()


def test_prefetch_loader_close_stops_a_blocked_worker():
    """An endless batch function with a full queue: close() drains it and
    the worker thread ends."""
    loader = nl.PrefetchLoader(lambda: np.zeros(1), depth=1)
    time.sleep(0.2)
    loader.close()
    assert not loader._thread.is_alive()
