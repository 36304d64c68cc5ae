"""The port's motion-compensated edit against the benchmark's plain float32
references (``benchmark/reference/raft.py`` and ``insv2v_flow.py``, which
import nothing of the port), on the CPU with the benchmark's seeded
weights: RAFT at ``RaftConfig.tiny()`` and at full widths, the warp,
``resize_flow``, the flow propagation and the DDPM tables and step, a tiny
motion-compensated DDPM edit through ``VideoEditor`` held to the
references step by step and as a whole window chain, the ``flow`` check
on a planted fault, and the flow path's spans and pair counter.

Tolerances: 1e-5 where the port and the reference compute the same
float32 operations in another order (RAFT's 3 or 12 updates through ~40
convolutions; ``F.grid_sample``'s normalised positions against the port's
explicit gather); 1e-4 for the edit's numbers and its latents, over a
UNet of ~40 residual blocks and DDPM updates that divide by sqrt(a_t)
(``tests/test_torch_sdxl.py``'s ``DEEP``)."""

import os
import sys

import numpy as np
import pytest
import torch

from insv2v_torch.diffusion import samplers as tsamp
from insv2v_torch.diffusion.pipeline import VideoEditor
from insv2v_torch.diffusion.schedules import (DiffusionSchedule, ddpm_step,
                                              make_sampler_tables)
from insv2v_torch.models import raft as traft
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.ops import resize as tresize
from insv2v_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark", "tests"))

import tiny_flow  # noqa: E402  (puts benchmark/ on the path)
from faults_flow import lookup_swap  # noqa: E402
from harness import load_module  # noqa: E402
from reference import insv2v as ref  # noqa: E402
from reference import insv2v_flow as fl  # noqa: E402
from reference import raft as rr  # noqa: E402
from reference.ops import rel  # noqa: E402
from test_torch_pipeline import CLIP_KW, VAE_KW, TinyTokenizer  # noqa: E402

SAME_OPS = 1e-5
DEEP = 1e-4
SEED = 2 ** 31 + 11
driver = load_module(os.path.join(REPO, "benchmark", "drivers", "edit_flow.py"),
                     "test_edit_flow_driver")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_raft(flow: dict):
    """The port's RAFT with the benchmark's seeded weights, and the weights."""
    W = driver.raft_weights(flow, SEED, "cpu")
    model = traft.RAFT(driver.raft_config(flow)).eval()
    model.load_state_dict(W, strict=False)
    return model, W


FULL = tiny_flow.Cell.load(tiny_flow.EDIT_FLOW).config["flow"]


@pytest.mark.parametrize("flow,size", [(dict(FULL, **tiny_flow.TINY_RAFT), (32, 48)),
                                       (FULL, (64, 64))], ids=["tiny", "full"])
def test_raft_matches_the_reference(flow, size):
    """Flows of two pairs (the second moved 3 pixels) at the tiny widths
    and at RAFT-large's on a 64 x 64 pair, whose fourth pyramid level is
    one pixel wide."""
    model, W = seeded_raft(flow)
    g = torch.Generator().manual_seed(0)
    im1 = torch.randn((2,) + size + (3,), generator=g) * 0.3
    im2 = torch.roll(im1, 3, dims=2)
    cfg = {k: flow[k] for k in ("corr_levels", "corr_radius", "iters")}
    with torch.no_grad():
        got = model(im1, im2)
        want = rr.raft_flow(W, cfg, im1, im2, block=1)
    assert got.shape == want.shape == (2,) + size + (2,)
    assert want.norm(dim=-1).mean() > 0.1
    assert rel(got, want) < SAME_OPS


def test_warp_resize_and_propagation_match_the_reference():
    """The port's ``warp_image`` (flows that leave the image), ``resize_flow``
    (384 -> 48 as in the cell) and ``_flow_propagate`` (two batch elements,
    masks from the warp) against the reference's."""
    g = torch.Generator().manual_seed(1)
    img = torch.randn((6, 9, 11, 4), generator=g)
    flow = torch.randn((6, 9, 11, 2), generator=g) * 4.0
    assert rel(tresize.warp_image(img, flow), fl.warp(img, flow)) < SAME_OPS
    big = torch.randn((3, 48, 40, 2), generator=g) * 10.0
    assert rel(tresize.resize_flow(big, 6, 5), fl.resize_flow(big, 6, 5)) < SAME_OPS
    f, r, h, w = 5, 2, 6, 7
    flows = torch.zeros((f, r, h, w, 2))
    flows[r:] = torch.randn((f - r, r, h, w, 2), generator=g) * 3.0
    ones = torch.ones((f * r, h, w, 1))
    masks = fl.warp(ones, flows.reshape(-1, h, w, 2)).reshape(f, r, h, w, 1)
    delta = torch.zeros((2, f, h, w, 4))
    delta[:, :r] = torch.randn((2, r, h, w, 4), generator=g)
    got = tsamp._flow_propagate(delta, flows, masks)
    want = fl.propagate(delta, flows, masks)
    assert (masks.sum(1) > 0.5).float().mean() < 1.0  # some pixels are left uncovered
    assert rel(got, want) < SAME_OPS


def test_ddpm_tables_and_step_match_the_reference():
    """The port's DDPM tables at the cell's 20 steps, its step with noise
    and the reference's recovery of the step's eps. The tables to 1e-4:
    the port derives them from alpha-bars stored in float32 (the JAX
    package's), and the variance's 1 - a_t / a_prev loses digits next to
    t = 0 (2.5e-5 at t = 50)."""
    tables = make_sampler_tables(DiffusionSchedule.create(), 20, kind="ddpm")
    want = fl.ddpm_tables(20)
    np.testing.assert_array_equal(tables.timesteps, want["t"])
    for got, key in ((tables.alpha_prod, "a"), (tables.alpha_prod_prev, "a_prev"),
                     (tables.variance, "var")):
        np.testing.assert_allclose(got, want[key], rtol=DEEP)
    g = torch.Generator().manual_seed(2)
    x, eps, noise = (torch.randn((1, 4, 6, 6, 4), generator=g) for _ in range(3))
    for i in (0, 9, 19):
        out, _ = ddpm_step(tables, x, eps, i, noise)
        assert rel(out, fl.ddpm_step(want, i, x, eps, noise)) < SAME_OPS
        assert rel(fl.ddpm_eps(want, i, x, out, noise), eps) < DEEP


@pytest.fixture(scope="module")
def edited():
    """One sound tiny edit (unit 0) and one with the lookup's offsets
    swapped (unit 1) through the cell's driver, float32 on the CPU."""
    cell = tiny_flow.tiny_flow_cell("float32")
    drv = cell.driver().Driver(cell, SEED, "cpu")
    drv.setup()
    tracing.clear()
    before = traft.RAFT.pairs
    drv.run_unit(0)
    drv.sound = {"pairs": traft.RAFT.pairs - before, "before": before,
                 "snapshot": tracing.snapshot()}
    owner, name, broken = lookup_swap()
    real = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        drv.run_unit(1)
    finally:
        setattr(owner, name, real)
    drv.release()
    return drv


def test_tiny_flow_edit_matches_the_references_step_by_step(edited):
    """Every number of the cell's check reads under ``DEEP``: the text, the
    VAE encode, the 3-way eps and the guided, flow-anchored eps of two
    steps a window, the stitch and the decode; and ``flow``, the drawn
    pairs' flows in units of the reference's own deviation at TF32, under
    1e-2 (a float32 program)."""
    prog, _ = edited.check(edited.records[0])
    assert set(prog) == set(edited.cell.spec["limits"])
    assert prog.pop("flow") < 1e-2
    assert all(v < DEEP for v in prog.values()), prog


def test_tiny_flow_edit_matches_the_reference_window_chain(edited):
    """The decoder's latents of the whole edit against the reference's
    window chain from the same draws, the reference's own VAE encode and
    its own RAFT's flows of every window."""
    drv, rec = edited, edited.records[0]
    c, t, W = drv.cfg, drv.t, drv.weights
    vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
    draws = {}
    for kind, x in rec.noise.draws:
        draws.setdefault(kind, []).append(x)
    frames = torch.as_tensor(rec.frames)
    with torch.no_grad():
        ids = torch.as_tensor(ref.hash_token_ids([rec.prompt, ""]))
        ctx = ref.clip_text(W["text"], ids, c["text"]["num_layers"], c["text"]["num_heads"])
        cond = torch.cat([ref.vae_sample(W["vae"], frames[i: i + d.shape[0]], d, vl, vb)
                          for i, d in zip(range(0, t["frames"], 16), draws["encode"])])
        rcfg = {k: c["flow"][k] for k in ("corr_levels", "corr_radius", "iters")}
        h, w = t["height"] // 8, t["width"] // 8
        flows = {k: fl.window_flows(drv.raft_w, rcfg, frames[s0: s0 + s_n], r_n, h, w)
                 for k, (s0, s_n, r_n) in enumerate(drv.windows) if r_n}
        want = fl.edit_latents(W["unet"], c["unet"], fl.ddpm_tables(t["steps"]), cond[None],
                               ctx[1:2], ctx[0:1], drv.windows, flows, draws, drv.correct_until,
                               t["text_cfg"], t["video_cfg"])
    assert len(draws["step"]) == len(drv.windows) * (t["steps"] - 1)
    got = rec.decode_in.reshape(want.shape)
    assert rel(got, want) < DEEP


def test_the_lookup_swap_fault_reads_above_the_flow_limit(edited):
    prog, _ = edited.check(edited.records[1])
    limit = edited.cell.spec["limits"]["flow"]
    assert prog["flow"] > 10 * limit, prog


def test_flow_spans_and_pair_counter(edited):
    """The sound edit's RAFT calls, pairs and spans: 8 pairs (2 queries x 2
    refs in each of two follow-up windows) in one ``flow.raft`` call a
    window, each call's spans, and ``sampler.flow_propagate`` in the two
    anchored steps of each follow-up window; an edit without motion
    compensation opens none of them."""
    snap = edited.sound["snapshot"]
    windows = len(edited.windows) - 1
    assert edited.sound["pairs"] == edited.pairs_per_edit == 8
    assert snap["counters"]["raft.pairs"] - edited.sound["before"] == 8
    iters = edited.cfg["flow"]["iters"]
    counts = snap["counts"]
    assert counts["flow.raft"] == counts["raft.encode"] == counts["raft.corr"] == windows
    assert counts["raft.upsample"] == windows
    assert counts["raft.lookup"] == counts["raft.update"] == windows * iters
    assert counts["sampler.flow_propagate"] == windows * edited.correct_until
    call = snap["spans"]["flow.raft"][0]
    inner = [r for name in ("raft.encode", "raft.lookup") for r in snap["spans"][name]
             if r.parent == call.id]
    assert len(inner) == 1 + iters
    # an edit without motion compensation
    torch.manual_seed(0)
    editor = VideoEditor(UNet3DConditionModel(UNetConfig.tiny()),
                         AutoencoderKL(VaeConfig(**VAE_KW)),
                         ClipTextEncoder(ClipTextConfig(**CLIP_KW)), tokenizer=TinyTokenizer(),
                         num_steps=2, device="cpu", dtype=torch.float32)
    tracing.clear()
    before = traft.RAFT.pairs
    frames = np.random.RandomState(0).uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
    editor(frames, "make it snowy", frames_per_window=4, num_ref_frames=2, timings={})
    names = set(tracing.snapshot()["spans"])
    assert "sampler.step" in names
    assert not {n for n in names if n.startswith(("raft.", "flow."))}
    assert "sampler.flow_propagate" not in names and traft.RAFT.pairs == before
