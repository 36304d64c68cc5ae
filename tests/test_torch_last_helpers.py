"""The port's last host helpers against the JAX package's, on the CPU:
the torch checkpoint loader on a full Lightning checkpoint (whose
``hyper_parameters`` the safe unpickler refuses), the fused-checkpoint
split, the UNet + motion merge, the implied noise of a known x0, the CLI
override of config keys, and the reference's image extras. Inputs come
from a numpy seed; tolerances are stated per test."""

import argparse
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insv2v_tpu.diffusion import schedules as jsched
from insv2v_tpu.utils import checkpoint as jckpt
from insv2v_tpu.utils import config as jconfig
from insv2v_tpu.utils import media as jmedia
from insv2v_tpu.utils.convert import merge_unet_motion_state_dicts as j_merge
from insv2v_torch.diffusion import schedules as tsched
from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
from insv2v_torch.utils import checkpoint as tckpt
from insv2v_torch.utils import config as tconfig
from insv2v_torch.utils import media as tmedia
from insv2v_torch.utils.convert import torch_state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores, where
    several threads per op mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FALLBACK = "falling back to torch.load"


def _tensors(rs, shapes):
    return {k: torch.from_numpy(rs.randn(*s).astype(np.float32)) for k, s in shapes.items()}


def _lightning(state_dict):
    """A full Lightning checkpoint as the reference's trainer saves it."""
    return {"state_dict": {"_forward_module." + k: v for k, v in state_dict.items()},
            "hyper_parameters": argparse.Namespace(lr=1e-5, accumulate_grad_batches=2),
            "epoch": 3, "global_step": 40}


# --- the loader ------------------------------------------------------------------

def test_lightning_checkpoint_loads_like_the_jax_loader(tmp_path):
    """Both loaders fall back, with a warning, and give the same keys and
    the same tensors bit for bit."""
    rs = np.random.RandomState(0)
    sd = _tensors(rs, {"vae.decoder.conv_in.bias": (8,), "unet.conv_in.weight": (4, 8, 3, 3),
                       "text_model.transformer.text_model.final_layer_norm.weight": (16,)})
    path = str(tmp_path / "last.ckpt")
    torch.save(_lightning(sd), path)
    with pytest.warns(UserWarning, match=FALLBACK):
        got = tckpt.load_torch_weights(path)
    with pytest.warns(UserWarning, match=FALLBACK):
        want = jckpt.load_torch_weights(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


def test_tensor_file_loads_without_a_warning(tmp_path):
    rs = np.random.RandomState(1)
    sd = _tensors(rs, {"a.weight": (3, 5), "b.bias": (7,)})
    path = str(tmp_path / "plain.pth")
    torch.save(sd, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tckpt.load_torch_weights(path)
    assert sorted(got) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("load", [tckpt.load_torch_weights, jckpt.load_torch_weights],
                         ids=["port", "jax"])
def test_missing_file_raises_file_not_found(tmp_path, load):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "absent.ckpt"))


VAE_KW = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4, resolution=16)
CLIP_KW = dict(vocab_size=49408, hidden_size=12, num_layers=1, num_heads=2, intermediate_size=24)


def test_fused_lightning_checkpoint_splits_like_the_jax_loader(tmp_path):
    """A tiny config's fused checkpoint in the reference's Lightning form
    (DeepSpeed prefix, the text model under ``transformer.``, a VAE
    ``loss.`` tree and a ``pos_encoder.pe`` table to drop, pickled
    hyper-parameters): the port's per-part state dicts against the JAX
    loader's trees carried back to torch, the same keys and tensors bit
    for bit; and they load into the port's models."""
    rs = np.random.RandomState(2)
    models = {"unet": UNet3DConditionModel(UNetConfig.tiny(in_channels=8, out_channels=4)),
              "vae": AutoencoderKL(VaeConfig(**VAE_KW)),
              "text_model": ClipTextEncoder(ClipTextConfig(**CLIP_KW))}
    fused = {}
    for prefix, name in (("unet.", "unet"), ("vae.", "vae"), ("text_model.transformer.",
                                                              "text_model")):
        shapes = {k: tuple(v.shape) for k, v in models[name].state_dict().items()}
        fused.update({prefix + k: v for k, v in _tensors(rs, shapes).items()})
    fused["unet.down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0."
          "attention_blocks.0.pos_encoder.pe"] = torch.zeros(1, 8, 8)
    fused["vae.loss.logvar"] = torch.zeros(())
    path = str(tmp_path / "insv2v.ckpt")
    torch.save(_lightning(fused), path)
    with pytest.warns(UserWarning, match=FALLBACK):
        sds = tckpt.load_pipeline_state_dicts(fused_ckpt=path)
    with pytest.warns(UserWarning, match=FALLBACK):
        jtrees = jckpt.load_pipeline_params(fused_ckpt=path)
    assert sorted(sds) == sorted(jtrees) == ["text", "unet", "vae"]
    for part, kind in (("unet", "unet3d"), ("vae", "vae"), ("text", "clip_text")):
        want = torch_state_dict_from_flax(jtrees[part], kind)
        assert sorted(sds[part]) == sorted(want), part
        for k in want:
            torch.testing.assert_close(sds[part][k], want[k], rtol=0, atol=0)
    tckpt.load_into(models, sds)
    for k, v in models["unet"].state_dict().items():
        torch.testing.assert_close(v, fused["unet." + k], rtol=0, atol=0)


def test_merge_unet_motion_matches_the_jax_merge():
    """tests/test_checkpoint.py's three cases through both merges: the same
    union, and the same ValueError on an overlap and on a wrong total."""
    a = {"x.weight": torch.ones(1)}
    b = {"y.weight": torch.ones(1)}
    got, want = tckpt.merge_unet_motion_state_dicts(a, b, expected_total=2), j_merge(a, b, 2)
    assert sorted(got) == sorted(want) == ["x.weight", "y.weight"]
    for args, match in (((a, a), "overlap"), ((a, b, 5), "got 2 expected 5")):
        with pytest.raises(ValueError, match=match):
            tckpt.merge_unet_motion_state_dicts(*args)
        with pytest.raises(ValueError, match=match):
            j_merge(*args)


def test_unet_and_motion_files_merge_through_the_new_function(tmp_path, monkeypatch):
    """load_pipeline_state_dicts merges the two UNet sources through
    merge_unet_motion_state_dicts, and drops the ``pos_encoder.pe`` tables
    after it."""
    rs = np.random.RandomState(3)
    unet = _tensors(rs, {"conv_in.weight": (4, 8, 3, 3)})
    motion = _tensors(rs, {"down_blocks.0.motion_modules.0.proj_out.weight": (8, 8)})
    motion["down_blocks.0.motion_modules.0.pos_encoder.pe"] = torch.zeros(1, 8, 8)
    paths = {}
    for name, sd in (("unet", unet), ("motion", _lightning(motion))):
        paths[name] = str(tmp_path / f"{name}.ckpt")
        torch.save(sd, paths[name])
    calls = []
    merge = tckpt.merge_unet_motion_state_dicts
    monkeypatch.setattr(tckpt, "merge_unet_motion_state_dicts",
                        lambda *a, **kw: calls.append(a) or merge(*a, **kw))
    with pytest.warns(UserWarning, match=FALLBACK):
        sds = tckpt.load_pipeline_state_dicts(unet_weights=paths["unet"],
                                              motion_weights=paths["motion"])
    assert len(calls) == 1
    assert sorted(sds["unet"]) == sorted([*unet, "down_blocks.0.motion_modules.0.proj_out.weight"])
    with pytest.raises(ValueError, match="overlap"):
        tckpt.load_pipeline_state_dicts(unet_weights=paths["unet"], motion_weights=paths["unet"])


# --- the schedule, the config, the image extras --------------------------------

@pytest.mark.parametrize("schedule", ["scaled_linear", "cosine"])
def test_pred_eps_from_x0_matches_jax(schedule):
    """Five timesteps, a batch of them, float32: within 1e-6 of the largest
    JAX value (the same float32 arithmetic; XLA may fuse the product into
    the subtraction, which moves the last bit)."""
    rs = np.random.RandomState(4)
    x_t, x0 = (rs.randn(5, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 250, 501, 999])
    want = np.asarray(jsched.pred_eps_from_x0(jsched.DiffusionSchedule.create(schedule),
                                              jnp.asarray(x_t), jnp.asarray(x0), jnp.asarray(t)))
    got = tsched.pred_eps_from_x0(tsched.DiffusionSchedule.create(schedule),
                                  torch.from_numpy(x_t), torch.from_numpy(x0.astype(np.float64)),
                                  torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    # the inverse of add_noise: the noise put in comes back out
    eps = rs.randn(*x0.shape).astype(np.float32)
    sched = tsched.DiffusionSchedule.create(schedule)
    noisy = tsched.add_noise(sched, torch.from_numpy(x0), torch.from_numpy(eps),
                             torch.from_numpy(t))
    back = tsched.pred_eps_from_x0(sched, noisy, torch.from_numpy(x0), torch.from_numpy(t))
    np.testing.assert_allclose(back.numpy(), eps, atol=1e-3)


def test_merge_args_matches_jax():
    cfg = {"lr": 1e-5, "expt_dir": "experiments", "trainer": {"max_steps": 10}}
    args = argparse.Namespace(lr=3e-4, expt_dir=None, seed=7, trainer=None)
    got = tconfig.merge_args(cfg, args)
    assert got == jconfig.merge_args(cfg, args)
    assert got == {"lr": 3e-4, "expt_dir": "experiments", "trainer": {"max_steps": 10},
                   "seed": 7}
    assert got is not cfg and cfg["lr"] == 1e-5


def _frames(seed, shape):
    return np.clip(np.random.RandomState(seed).randn(*shape) * 0.6, -1, 1).astype(np.float32)


def test_canny_edges_bit_equal():
    frames = _frames(5, (3, 32, 40, 3))
    got, want = tmedia.canny_edges(frames), jmedia.canny_edges(frames)
    assert got.shape == (3, 32, 40, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmedia.canny_edges(frames, 20, 60),
                                  jmedia.canny_edges(frames, 20, 60))
    assert set(np.unique(got)) <= {-1.0, 1.0} and (got == 1.0).any()


def test_match_histogram_bit_equal():
    src, ref = _frames(6, (24, 20, 3)), _frames(7, (30, 18, 3)) * 0.5 + 0.2
    got = tmedia.match_histogram(src, ref)
    np.testing.assert_array_equal(got, jmedia.match_histogram(src, ref))
    assert got.shape == src.shape and got.min() >= -1.0 and got.max() <= 1.0


def test_overlay_text_bit_equal():
    frame = _frames(8, (48, 64, 3))
    for text, scale in (("make it snowy", 0.5), ("x", 1.0)):
        got = tmedia.overlay_text(frame, text, scale)
        np.testing.assert_array_equal(got, jmedia.overlay_text(frame, text, scale))
        assert got.shape == frame.shape and not np.array_equal(got, frame)
