"""The port's data-generation workload against the JAX package, float32 on
the CPU at tiny sizes: the prompt-diff text machinery, both
prompt-to-prompt samplers (JAX's per-step noise fed through the port's
seam) and the ``generate_dataset`` CLI with ``--device cpu --tiny``."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.diffusion import ptp_sampler as jptp
from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.models.modelscope_t2v import ModelScopeConfig as JMsCfg
from insv2v_tpu.models.modelscope_t2v import UNetSD as JUNetSD
from insv2v_tpu.text import prompt_diff as jdiff
from insv2v_tpu.text.tokenizer import HashTokenizer as JHashTokenizer
from insv2v_tpu.utils.convert import convert_unet_sd_state_dict
from insv2v_torch.apps import generate_dataset
from insv2v_torch.data.datasets import VideoPromptToPromptDataset
from insv2v_torch.diffusion import ptp_sampler as tptp
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.modelscope_t2v import ModelScopeConfig, UNetSD
from insv2v_torch.text import prompt_diff as tdiff
from insv2v_torch.text.tokenizer import HashTokenizer
from insv2v_torch.utils.convert import torch_state_dict_from_flax
from oracles.unet_sd_oracle import OracleUNetSD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG, JCFG = ModelScopeConfig.tiny(context_dim=12), JMsCfg.tiny(context_dim=12)
PROMPTS = [("a cat walking on the grass", "a dog walking on the grass"),
           ("a red car", "a red car in the snow at night"),
           ("a man riding a horse on the beach", "a man on the beach"),
           ("two birds fly", "three small birds fly away")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- prompt diff ----------------------------------------------------------------


def pieces_tuple(pieces):
    return [(type(p).__name__, p.old, p.new, p.weight) for p in pieces]


@pytest.mark.parametrize("old,new", PROMPTS)
def test_prompt_diff_matches_jax(old, new):
    """``compute_diff``, ``token_alignment`` and ``build_ptp_key_value`` on
    the same prompts: the pieces and the alignment exactly, the (key,
    value) arrays to 0 (one deterministic encoder: a fixed embedding table
    per token id, HashTokenizer ids)."""
    tp, jp = tdiff.compute_diff(old, new), jdiff.compute_diff(old, new)
    assert pieces_tuple(tp) == pieces_tuple(jp)
    for p in tp + jp:
        if p.old != p.new:
            p.weight = 3.0
    count = lambda text: len(text.split()) + text.count("a")
    assert tdiff.token_alignment(tp, count) == jdiff.token_alignment(jp, count)
    table = np.random.RandomState(0).randn(49408, 6).astype(np.float32)
    encode = lambda ids: table[np.asarray(ids)]
    for offset in (1, 0):
        got = tdiff.build_ptp_key_value(tp, HashTokenizer(), encode, token_offset=offset)
        want = jdiff.build_ptp_key_value(jp, JHashTokenizer(), encode, token_offset=offset)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# --- the samplers -----------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_pair():
    """Tiny UNetSD params for both packages: the torch oracle's, its
    zero-initialised heads made random, through the JAX converter; and the
    port's UNetSD on them."""
    torch.manual_seed(1)
    oracle = OracleUNetSD()
    with torch.no_grad():
        for p in oracle.parameters():
            if p.abs().max() == 0:
                p.copy_(torch.randn_like(p) * 0.05)
    params = convert_unet_sd_state_dict(oracle.state_dict(), JCFG)
    model = UNetSD(CFG).eval()
    model.load_state_dict(torch_state_dict_from_flax(params, "unet_sd", CFG), strict=True)
    return params, model


def jax_ptp_noises(seed, steps, shape):
    """The normals JAX's PTP sampler draws at each step: the carried key
    split, ``n_old = normal(sub)``, ``n_new = normal(fold_in(sub, 1))``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(tuple(np.asarray(jax.random.normal(k, shape, dtype=jnp.float32))
                         for k in (sub, jax.random.fold_in(sub, 1))))
    return out


def ptp_inputs(seed=2):
    rs = np.random.RandomState(seed)
    lat = rs.randn(1, 2, 8, 8, 4).astype(np.float32)
    ctx = [rs.randn(1, 5, 12).astype(np.float32) for _ in range(5)]
    return lat, ctx  # new, old, key, value, uncond


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_ptp_sampler_matches_jax(unet_pair, version):
    """DDPM, 4 steps, phase boundaries 1 and 3 (all three phases run), 2
    frames of 8x8: the port's sampler against JAX's on the same weights,
    inputs and per-step noise (fed through the seam). Tolerance 1e-4 on
    both final latents (float32 through 10-16 UNet calls)."""
    params, model = unet_pair
    lat, (cn, co, ck, cv, cu) = ptp_inputs()
    jtab = jsched.make_sampler_tables(jsched.DiffusionSchedule.create(), 4, kind="ddpm")
    ttab = tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), 4, kind="ddpm")
    jfn = jptp.sample_ptp_pair if version == "v2" else jptp.sample_ptp_pair_v1
    tfn = tptp.sample_ptp_pair if version == "v2" else tptp.sample_ptp_pair_v1
    unet_apply = lambda p, x, t, c, share: JUNetSD(cfg=JCFG).apply({"params": p}, x, t, c,
                                                                   sa_share=share)
    want = jax.jit(lambda p, l, a, b, k, v, u: jfn(
        unet_apply, p, jtab, l, a, b, (k, v), u, jax.random.PRNGKey(7), guidance_scale=7.0,
        sa_steps=1, ca_steps=3))(params, *map(jnp.asarray, (lat, cn, co, ck, cv, cu)))
    noises = jax_ptp_noises(7, 4, lat.shape)
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        got = tfn(lambda x, ts, c, share: model(x, ts, c, sa_share=share), ttab, t(lat),
                  t(cn), t(co), (t(ck), t(cv)), t(cu), guidance_scale=7.0, sa_steps=1,
                  ca_steps=3, noise=lambda i, shape: tuple(t(a) for a in noises[i]))
    for key in ("latent", "latent_old"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_ptp_v1_keeps_the_pair_identical_through_sa_end(unet_pair):
    """v1: phase 1 denoises the old branch alone and copies it, so the two
    branches enter phase 2 bit for bit equal and only then diverge (the
    new branch takes the (key, value) context); v2 diverges at once."""
    _, model = unet_pair
    lat, (cn, co, ck, cv, cu) = ptp_inputs(3)
    tab = tsched.make_sampler_tables(tsched.DiffusionSchedule.create(), 5, kind="ddim")
    t = lambda a: torch.from_numpy(a)
    for fn, same_at_sa_end in ((tptp.sample_ptp_pair_v1, True), (tptp.sample_ptp_pair, False)):
        calls = []

        def unet(x, ts, c, share):
            calls.append(x.clone())
            return model(x, ts, c, sa_share=share)

        with torch.no_grad():
            out = fn(unet, tab, t(lat), t(cn), t(co), (t(ck), t(cv)), t(cu), sa_steps=2,
                     ca_steps=4)
        # phase 1: one call a step; phase 2's first step: old, then new
        x_old, x_new = calls[2][:1], calls[3][:1]
        assert torch.equal(x_old, x_new) == same_at_sa_end
        assert not torch.equal(out["latent"], out["latent_old"])


def test_frac_phase_steps_matches_jax():
    for frac in (0.0, 0.3, 0.35, 0.4, 0.45, 0.6, 0.65, 0.8, 0.85, 1.0):
        for s in (3, 6, 20, 30, 50):
            assert tptp.frac_phase_steps(frac, s) == jptp.frac_phase_steps(frac, s)


# --- the CLI ----------------------------------------------------------------------


def jax_cli_draws(seed, n):
    """The JAX CLI's hyper draws (``apps/generate_dataset.py``: seed,
    guidance, sa_end, ca_end, edit_weight per attempt), replayed."""
    rs, out = np.random.RandomState(seed), []
    for _ in range(n):
        s = int(rs.randint(0, 2**31 - 1))
        guidance = float(rs.randint(5, 13))
        sa_end = round(float(rs.choice(np.linspace(0.3, 0.45, 4))), 2)
        ca_end = round(float(rs.choice(np.linspace(0.6, 0.85, 6))), 2)
        edit_weight = float(rs.randint(1, 6))
        out.append((s, guidance, sa_end, ca_end, edit_weight))
    return out


def test_hyper_draws_replay_the_jax_cli():
    rs = np.random.RandomState(11)
    assert [generate_dataset.hyper_draws(rs) for _ in range(20)] == jax_cli_draws(11, 20)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_generate_dataset_cli_cpu(tmp_path, version):
    """``--device cpu --tiny``, 3 steps, 2 frames at latent 8: 4 JPEGs,
    ``prompt.json``, a ``metadata.jsonl`` record with the variant and the
    JAX CLI's draws, a GIF; the port's dataset reads the pair back; a
    resume with the other variant warns; without ``--device`` and without
    a GPU it raises."""
    prompts = [{"input": "a cat walking", "output": "a dog walking",
                "edit": "turn the cat into a dog"}]
    pfile = str(tmp_path / "prompts.json")
    with open(pfile, "w") as f:
        json.dump(prompts, f)
    out_dir = str(tmp_path / "gen")
    argv = ["--prompts", pfile, "--output-dir", out_dir, "--tiny", "--allow-random-weights",
            "--no-clip-filter", "--max-attempts", "1", "--steps", "3", "--num-frames", "2",
            "--latent-size", "8", "--seed", "5"]
    result = generate_dataset.main(argv + ["--num-samples", "1", "--ptp-version", version,
                                           "--device", "cpu"])
    sample = os.path.join(out_dir, "sample_000000")
    assert json.load(open(os.path.join(sample, "prompt.json"))) == prompts[0]
    jpgs = sorted(f for f in os.listdir(os.path.join(sample, "image")) if f.endswith(".jpg"))
    records = [json.loads(line) for line in open(os.path.join(sample, "metadata.jsonl"))]
    assert len(jpgs) == 4 and len(records) == 1 and records == result["records"]
    rec = records[0]
    assert rec["ptp_version"] == version and rec["accepted"]
    assert (rec["seed"], rec["guidance"], rec["sa_end"], rec["ca_end"],
            rec["edit_weight"]) == jax_cli_draws(5, 1)[0]
    assert jpgs[0] == f"{rec['seed']}_0_0000.jpg"
    assert os.path.exists(os.path.join(sample, f"{rec['seed']}.gif"))
    ds = VideoPromptToPromptDataset(out_dir, num_frames=2, rng=np.random.RandomState(0))
    ds.source_frames = 2
    item = ds[0]
    assert len(ds) == 1 and item["input_video"].shape == (2, 16, 16, 3)
    assert item["output_prompt"] == "a dog walking"

    other = "v1" if version == "v2" else "v2"
    buf = io.StringIO()
    with redirect_stdout(buf):
        generate_dataset.main(argv + ["--num-samples", "2", "--ptp-version", other,
                                      "--device", "cpu"])
    assert "mix PTP variants" in buf.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_dataset.main(argv + ["--num-samples", "3"])


def test_datagen_modules_import_no_jax():
    code = ("import sys\n"
            "import insv2v_torch.apps.generate_dataset, insv2v_torch.models.modelscope_t2v\n"
            "import insv2v_torch.models.openclip_text, insv2v_torch.diffusion.ptp_sampler\n"
            "import insv2v_torch.text.prompt_diff\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'insv2v_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
