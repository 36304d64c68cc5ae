"""The port's data-parallel training (insv2v_torch.parallel.dist and the
trainer with a group) against the JAX package, on two gloo processes
spawned on the CPU at the tiny configs of tests/test_torch_training.py:

  * the two-rank step, with the JAX step's draws replayed and each rank
    given its share of every microbatch, against the JAX one-process
    ``Trainer`` step on the same global batch: loss 1e-5 relative, the mean
    gradient 1e-4 of each tensor's largest entry, the updated masters 1e-5
    (tests/test_torch_training.py's tolerances);
  * ``Adam`` and ``Adam8bit`` sharded over two ranks against the unsharded
    optimizer (1e-6 of each tensor's largest entry), the consolidated
    state dict, and ``assert_zero_sharded`` passing and biting;
  * ``multihost_check`` and the train CLI as two processes each, and the
    CLI's seed for each rank and step.

The frame- and batch-sharded windows are in
tests/test_torch_parallel_windows.py."""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

# the JAX step and the port models of tests/test_torch_training.py (its
# fixtures run here in this module's own scope)
from test_torch_training import jax_setup, jax_step, port_models  # noqa: F401
from test_torch_training_parts import TINY_YAML, make_ptp_data
from insv2v_torch.parallel import dist as pdist
from insv2v_torch.training import trainer as ttrainer
from insv2v_torch.training.quantized_adam import Adam8bit


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs: its ops are
    small, and the suite's parallel workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_training.py's step: accum 2 of microbatches of 2, so
# one row of each microbatch per rank
ACCUM, RANKS = 2, 2
# tensor sizes whose greedy partition over two ranks is [0, 0, 1, 1, 0]
PARTITION_SIZES = [10, 50, 30, 30, 5]


# --- the ranks' side (run in spawned processes) ----------------------------------

def _dp_rank(group, unet_p, vae_p, clip_p, batch, draws):
    """One data-parallel step on this rank's share, and the sharded
    optimizer's checks. Each draw's leading axis is the microbatch's rows
    (b * frames rows for the posterior normals): this rank takes its share."""
    torch.set_num_threads(1)
    r, n = group.rank, group.size
    local = pdist.local_batch_slice(batch, ACCUM, r, n)
    local_draws = [{k: v[pdist.shard_range(len(v), r, n)] for k, v in d.items()}
                   for d in draws]
    trainer = ttrainer.Trainer(*port_models(unet_p, vae_p, clip_p), ttrainer.TrainConfig(
        lr=1e-3, accumulate_grad_batches=ACCUM), group=group)
    state = trainer.create_state()
    loss, grads = trainer.accumulate_grads(state, local, draws=local_draws)
    out = {"loss": float(loss), "grads": {k: g.numpy().copy() for k, g in
                                          zip(state.params, grads)}}
    state, metrics = trainer.train_step(state, local, draws=local_draws)
    out["step_loss"] = metrics["train_loss"]
    out["masters"] = {k: v.numpy().copy() for k, v in state.params.items()}
    model = dict(trainer.unet.named_parameters())
    out["model_equals_masters"] = all(torch.equal(model[k], v) for k, v in state.params.items())
    out["bytes"], out["whole"] = pdist.assert_zero_sharded(state.optimizer, group)
    # the same step's state replicated: an unsharded optimizer on every rank
    plain = ttrainer.make_optimizer(trainer.cfg, list(state.params.values()))
    for m, g in zip(state.params.values(), grads):
        m.grad = g
    plain.step()
    try:
        pdist.assert_zero_sharded(plain, group)
        out["replicated_raised"] = False
    except AssertionError:
        out["replicated_raised"] = True
    out["optim"] = {kind: _optimizer_invariance(group, kind) for kind in ("adam", "adam8bit")}
    out["partition"] = _owned(ZeroRedundancyOptimizer(
        [torch.zeros(n) for n in PARTITION_SIZES], optimizer_class=torch.optim.Adam, lr=1e-3))
    return out


def _owned(zero):
    """The indices of the tensors whose optimizer state this rank holds."""
    index = {id(p): i for i, p in enumerate(zero.param_groups[0]["params"])}
    return sorted(index[id(p)] for g in zero.optim.param_groups for p in g["params"])


def _optimizer_invariance(group, kind):
    """Two steps of the sharded and the unsharded optimizer on the same
    masters and gradients (tensors above and below Adam8bit's quantization
    size): the worst difference of each tensor relative to its largest
    entry, the state dict gathered on rank 0 against the unsharded one,
    and a third step after loading that dict into a fresh sharded
    optimizer."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(80, 64), (300,), (4096, 3), (17,), (33, 40), (5000,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * 0.1 for s in shapes] for _ in range(3)]
    cls, kw = {"adam": (torch.optim.Adam, dict(lr=1e-2, eps=1e-8)),
               "adam8bit": (Adam8bit, dict(lr=1e-2))}[kind]
    sharded_p = [t.clone() for t in init]
    plain_p = [t.clone() for t in init]
    sharded = ZeroRedundancyOptimizer(sharded_p, optimizer_class=cls, **kw)
    plain = cls(plain_p, **kw)
    for step in range(2):
        for opt, ps in ((sharded, sharded_p), (plain, plain_p)):
            for p, g in zip(ps, grads[step]):
                p.grad = g.clone()
            opt.step()
            opt.zero_grad()
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(sharded_p, plain_p))
    got = pdist.gather_optimizer_state(sharded, group, to=0)
    same_state = None
    reloaded_worst = None
    if group.rank == 0:
        want = plain.state_dict()
        same_state = (got["param_groups"] == want["param_groups"]
                      and _tree_equal(got["state"], want["state"]))
    fresh_p = [p.clone() for p in sharded_p]
    full = copy.deepcopy(plain.state_dict())  # every rank loads the unsharded layout
    fresh = ZeroRedundancyOptimizer(fresh_p, optimizer_class=cls, **kw)
    fresh.load_state_dict(full)
    for opt, ps in ((fresh, fresh_p), (plain, plain_p)):
        for p, g in zip(ps, grads[2]):
            p.grad = g.clone()
        opt.step()
    reloaded_worst = max(((a - b).abs().max() / b.abs().max()).item()
                         for a, b in zip(fresh_p, plain_p))
    return {"worst": worst, "same_state": same_state, "reloaded_worst": reloaded_worst,
            "owned": _owned(sharded), "gathered_here": got is not None}


def _tree_equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def dp_ranks(jax_setup, jax_step):
    _, unet_p, vae_p, clip_p = jax_setup
    return pdist.spawn(_dp_rank, RANKS, unet_p, vae_p, clip_p, jax_step["batch"],
                       jax_step["draws"], timeout_s=240)


def assert_close_rel(got, want, names, rel):
    for name in names:
        w = want[name]
        np.testing.assert_allclose(got[name], w, atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


# --- data parallel against JAX -------------------------------------------------------

def test_dp_step_matches_jax_trainer(dp_ranks, jax_step):
    """Both ranks: the global mean loss to 1e-5 relative, the all-reduced
    mean gradient to 1e-4 of each tensor's largest entry, and the updated
    masters to 1e-5 (1 % of lr 1e-3: a first Adam step is
    lr * g / (|g| + eps), so an entry whose gradient is near zero magnifies
    the float32 gradient difference), against the JAX one-process step on
    the same global batch."""
    for out in dp_ranks:
        names = list(out["masters"])
        np.testing.assert_allclose(out["loss"], jax_step["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["step_loss"], jax_step["loss"], rtol=1e-5)
        assert_close_rel(out["grads"], jax_step["mean_grads"], names, 1e-4)
        for name in names:
            np.testing.assert_allclose(out["masters"][name], jax_step["new_params"][name],
                                       atol=1e-5, err_msg=name)
        assert out["model_equals_masters"]


def test_dp_ranks_hold_the_same_masters(dp_ranks):
    a, b = (out["masters"] for out in dp_ranks)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_zero_sharded_state_passes_and_a_replicated_one_raises(dp_ranks):
    held = dp_ranks[0]["bytes"]
    whole = dp_ranks[0]["whole"]
    assert dp_ranks[1]["bytes"] == held and len(held) == RANKS
    assert sum(held) == whole and all(0 < b < whole for b in held)
    assert all(out["replicated_raised"] for out in dp_ranks)


@pytest.mark.parametrize("kind", ["adam", "adam8bit"])
def test_sharded_optimizer_equals_unsharded(dp_ranks, kind):
    """Two steps, then a third after a reload: 1e-6 of each tensor's
    largest entry; the consolidated state dict equals the unsharded one
    exactly; each rank owns whole tensors and together all of them."""
    for out in dp_ranks:
        res = out["optim"][kind]
        assert res["worst"] <= 1e-6
        assert res["reloaded_worst"] <= 1e-6
    assert dp_ranks[0]["optim"][kind]["same_state"]
    assert [out["optim"][kind]["gathered_here"] for out in dp_ranks] == [True, False]
    owned = [set(out["optim"][kind]["owned"]) for out in dp_ranks]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    assert owned[0] | owned[1] == set(range(6))


# --- layout and partition ------------------------------------------------------------

def test_local_batch_slice_takes_each_ranks_share_of_every_microbatch():
    batch = {"x": np.arange(12), "t": torch.arange(12)}
    # accum 3 microbatches of 4 rows over 2 ranks: two rows of each
    assert pdist.local_batch_slice(batch, 3, 0, 2)["x"].tolist() == [0, 1, 4, 5, 8, 9]
    assert pdist.local_batch_slice(batch, 3, 1, 2)["t"].tolist() == [2, 3, 6, 7, 10, 11]
    with pytest.raises(ValueError):
        pdist.local_batch_slice(batch, 5, 0, 2)


def test_zero_partition_is_greedy_by_whole_tensors(dp_ranks):
    """The optimizer state goes to the ranks by whole tensors, largest
    first, each to the rank holding the fewest values so far."""
    assert [out["partition"] for out in dp_ranks] == [[0, 1, 4], [2, 3]]


# --- processes -----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(args_of, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", *args_of(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_multihost_check_two_processes():
    port = _free_port()
    outs = _run_pair(lambda r: ["insv2v_torch.parallel.multihost_check", str(r), "2",
                                str(port), "--device", "cpu"])
    losses = set()
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST_OK")]
        assert line and f"process={r}/2" in line[0], out
        losses.add(line[0].split("loss=")[1])
    assert len(losses) == 1, losses


def _write_cli_config(root, expt_dir):
    """tests/test_torch_training_parts.py's YAML, with the text width of
    the config's CLIP ViT-L/14 (the processes build it unpatched), one
    checkpoint a step and no validation."""
    cfg = root / f"{expt_dir.name}.yaml"
    cfg.write_text(TINY_YAML.format(tmp=root)
                   .replace(f"{root}/experiments", str(expt_dir))
                   .replace("cross_attention_dim: 32", "cross_attention_dim: 768")
                   .replace("checkpoint_every: 2", "checkpoint_every: 1")
                   .replace("val_every: 2", "val_every: 0"))
    return cfg


def _train_pair(cfg, *extra):
    port = _free_port()
    return _run_pair(lambda r: ["insv2v_torch.apps.train", "--config", str(cfg),
                                "--allow-random-weights", "--device", "cpu", *extra,
                                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                                "--process-id", str(r)])


def _assert_whole_checkpoint(path):
    saved = torch.load(path, weights_only=True)
    n = len(saved["params"])
    assert sorted(saved["optimizer"]["state"]) == list(range(n))
    assert saved["optimizer"]["param_groups"][0]["params"] == list(range(n))


@pytest.fixture(scope="module")
def cli_step1(tmp_path_factory):
    """One step of the train CLI on two CPU processes (the config's CLIP
    ViT-L/14 text tower, random): (the experiment folder, each rank's
    output)."""
    root = tmp_path_factory.mktemp("cli")
    make_ptp_data(root / "ptp")
    expt = root / "step1"
    outs = _train_pair(_write_cli_config(root, expt), "--max-steps", "1")
    return root, expt / "tiny", outs


def test_train_cli_two_processes_rank0_alone_writes(cli_step1):
    """Rank 0 alone writes metrics.jsonl (one record) and the checkpoint,
    whose optimizer state is the whole, unsharded one; both ranks end with
    the same motion masters."""
    _, expt, outs = cli_step1
    assert sorted(p.name for p in expt.iterdir()) == ["metrics.jsonl", "step_00000001.pt"]
    records = [json.loads(line) for line in open(expt / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1] and np.isfinite(records[0]["train_loss"])
    assert "step 1:" in outs[0] and "checkpointed" in outs[0]
    assert "motion masters equal on 2 ranks" in outs[0]
    assert "step 1:" not in outs[1] and "checkpointed" not in outs[1]
    _assert_whole_checkpoint(expt / "step_00000001.pt")


def test_train_cli_two_processes_resume_into_the_sharded_state(cli_step1):
    """A copy of the step-1 run resumed to step 2 on two processes: every
    rank loads its share of the whole optimizer state; rank 0 logs the
    resume and step 2 alone and writes a whole checkpoint; the ranks'
    masters agree."""
    import shutil

    root, expt1, _ = cli_step1
    expt = root / "resumed"
    shutil.copytree(expt1, expt / "tiny")
    outs = _train_pair(_write_cli_config(root, expt), "--max-steps", "2", "-r")
    assert "resumed at step 1" in outs[0] and "step 2:" in outs[0]
    assert "motion masters equal on 2 ranks after step 2" in outs[0]
    assert "resumed" not in outs[1] and "step 2:" not in outs[1]
    records = [json.loads(line) for line in open(expt / "tiny" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    _assert_whole_checkpoint(expt / "tiny" / "step_00000002.pt")


def test_train_cli_draws_a_stream_per_rank_and_step():
    """The CLI's data and noise seeds: ``seed + rank`` from step 0 (the JAX
    CLI's ``seed + process_index``); across a resume no two (rank, step)
    pairs share a stream, so rank 0 resumed at step 1 does not replay what
    rank 1 drew from step 0."""
    from insv2v_torch.apps.train import draw_seed

    assert [draw_seed(7, r, 0) for r in range(3)] == [7, 8, 9]
    seeds = {(r, s): draw_seed(7, r, s) for r in range(4) for s in range(6)}
    assert len(set(seeds.values())) == len(seeds)
    resumed = np.random.RandomState(draw_seed(7, 0, 1)).randint(0, 2 ** 31, 16)
    fresh = np.random.RandomState(draw_seed(7, 1, 0)).randint(0, 2 ** 31, 16)
    assert not np.intersect1d(resumed, fresh).size


def test_parallel_and_loader_modules_import_no_jax():
    code = ("import sys\n"
            "import insv2v_torch.parallel.dist, insv2v_torch.parallel.inference\n"
            "import insv2v_torch.parallel.multihost_check, insv2v_torch.data.native_loader\n"
            "import insv2v_torch.apps.train, insv2v_torch.training.trainer\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'insv2v_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
