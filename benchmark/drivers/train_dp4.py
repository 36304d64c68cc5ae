"""The data-parallel training driver: the training cell's optimizer step
(``train.py``) on R ranks over NCCL, one card each, the optimizer state
sharded over the ranks (``ZeroRedundancyOptimizer``), each rank with its
own share of the dataset and its own loader.

Rank 0 is the driver itself, on ``cuda:0`` in the benchmark's process,
so that its peak memory and its profiled stretch are a real rank's. Set-up
writes the synthetic dataset from the seed and gives each rank its
quarter of the samples, then starts ranks 1..R-1 as processes of this
file (``python3 train_dp4.py --rank r ...``), each on a socket of its own
to rank 0. A rank builds the models from the seed (the same weights on
every rank), its loader and the trainer over the group, and says it is
ready; every step after that runs on all ranks at once: rank 0 tells the
others to take a step each time it takes one. The others hand back plain
numbers only (a step's loss; after the checked step the first gradient's
norm and first elements of each leaf whose optimizer state they hold,
and a digest of every master).

A step's global batch is R x ``accumulate`` microbatches. ``check`` has
every rank rebuild its own batch from the files and run the float32
reference (``reference/train.py``'s pieces) over its own microbatches on
its card; the gradient sums meet in one plain ``all_reduce``, and rank 0
holds the program to the reference as the training cell does, plus
``masters``: the (rank, leaf) pairs whose master differs from rank 0's
after the checked step.

Failures end every rank within a minute: the process group's timeout is
60 s, rank 0 gives up on a rank that has exited or that has not answered
in its time, and a rank whose parent process is gone, or whose socket
closes, exits.
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import hashlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Connection
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for _p in (BENCH, os.path.dirname(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import Readings, derive_seed, load_module, log  # noqa: E402
from reference import insv2v as ref_v2v  # noqa: E402
from reference import train as ref  # noqa: E402
from reference.ops import precision, strict_fp32  # noqa: E402

base = load_module(os.path.join(HERE, "train.py"), "bench_drivers_train_base")
MOTION, SAMPLE = base.MOTION, base.SAMPLE

TIMEOUT_S = 60          # the process group's timeout: a collective that waits longer fails
READY_S = 900           # a rank's set-up (imports, weights, loader, kernels)
REPLY_S = 300           # a step's or a check's answer, past the collectives' own timeout
HOST_MICRO = base.HOST_MICRO


# --- what every rank runs -----------------------------------------------------------

def no_exchange():
    """The planted fault: the trainer's gradient exchange left out, each
    rank stepping on its own microbatches' mean."""
    from insv2v_torch.parallel.dist import Group

    return Group, "all_reduce_mean", lambda self, t: t


FAULTS = {"no_exchange": no_exchange}


def share_dir(root: str, rank: int) -> str:
    return os.path.join(root, f"rank_{rank}")


def write_shares(root: str, seed: int, t: dict, world: int) -> None:
    """The cell's ``samples`` folders from the seed, each rank's contiguous
    share of them moved under ``rank_<r>/``."""
    every = os.path.join(root, "all")
    base.write_dataset(every, seed, t["samples"], t["frames"], t["size"])
    per = t["samples"] // world
    for r in range(world):
        os.makedirs(share_dir(root, r))
        for j in range(r * per, (r + 1) * per):
            name = f"sample_{j:06d}"
            os.rename(os.path.join(every, name), os.path.join(share_dir(root, r), name))
    shutil.rmtree(every)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().float().cpu().numpy().tobytes()).hexdigest()


class Rank:
    """One rank's models, loader, trainer and state over the default
    process group, and its part of the check."""

    def __init__(self, cfg: dict, t: dict, seed: int, rank: int, world: int, root: str,
                 device: torch.device):
        self.cfg, self.t, self.seed = cfg, t, seed
        self.rank, self.world, self.root, self.device = rank, world, root, device
        self.dtype = getattr(torch, cfg["dtype"])
        self.steps_done = 0
        self.batches: List[Dict] = []
        self.loader = None

    def setup(self):
        from insv2v_torch.data.datasets import VideoPromptToPromptMotionAug
        from insv2v_torch.data.native_loader import PrefetchLoader
        from insv2v_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
        from insv2v_torch.models.unet3d import UNet3DConditionModel, UNetConfig
        from insv2v_torch.models.vae import AutoencoderKL, VaeConfig
        from insv2v_torch.ops import attention
        from insv2v_torch.parallel.dist import Group
        from insv2v_torch.text.tokenizer import HashTokenizer
        from insv2v_torch.training.trainer import TrainConfig, Trainer
        from harness import load_weights, seeded_weights

        t, c, seed = self.t, self.cfg, self.seed
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        with torch.device("meta"):
            models = {"unet": UNet3DConditionModel(UNetConfig(**tup(c["unet"]), remat=t["remat"])),
                      "vae": AutoencoderKL(VaeConfig(**tup(c["vae"]))),
                      "text": ClipTextEncoder(ClipTextConfig(**c["text"]))}
        self.weights = {n: seeded_weights(m, derive_seed(seed, n), self.device, self.dtype)
                        for n, m in models.items()}
        self.motion_init = {k: v.clone() for k, v in self.weights["unet"].items() if MOTION in k}
        for n, m in models.items():
            load_weights(m, self.weights[n])
        attention.FLASH_HEADFOLD = t["headfold"]
        dataset = VideoPromptToPromptMotionAug(
            share_dir(self.root, self.rank), num_frames=t["frames"],
            rng=np.random.RandomState(derive_seed(seed, "dataset", self.rank) % 2 ** 32),
            **t["augmentation"])
        batches = base.batch_iterator(
            dataset, t["accumulate"] * t["micro_batch"], t["prompt_type"], HashTokenizer(),
            np.random.RandomState(derive_seed(seed, "batches", self.rank) % 2 ** 32))
        pin = self.device.type == "cuda"

        def host_batch():
            out = {k: torch.from_numpy(v) for k, v in next(batches).items()}
            return {k: v.pin_memory() for k, v in out.items()} if pin else out

        self.loader = PrefetchLoader(host_batch, depth=2)
        tcfg = TrainConfig(lr=t["lr"], betas=tuple(t["betas"]), optimizer=t["optimizer"],
                           loss_type=t["loss"], prediction_type=t["prediction"],
                           cond_image_dropout=t["cond_image_dropout"],
                           scale_factor=c["scale_factor"], accumulate_grad_batches=t["accumulate"],
                           **{k: c["diffusion"][k] for k in ("beta_schedule",
                              "num_train_timesteps", "beta_start", "beta_end")})
        self.models = models
        self.group = Group()
        self.trainer = Trainer(models["unet"], models["vae"], models["text"], tcfg,
                               group=self.group)
        self.state = self.trainer.create_state()

    def draws(self, step: int) -> List[Dict[str, torch.Tensor]]:
        """This rank's microbatch draws of a step, from the seed."""
        t, dev = self.t, self.device
        b, f, h = t["micro_batch"], t["frames"], t["size"] // 8
        gen = torch.Generator(device=dev)
        gen.manual_seed(derive_seed(self.seed, "draws", step, self.rank))
        out = []
        for _ in range(t["accumulate"]):
            n = lambda *s: torch.randn(s, generator=gen, device=dev)
            out.append({"enc_cond": n(b * f, h, h, 4), "enc_edit": n(b * f, h, h, 4),
                        "drop": torch.rand(b, generator=gen, device=dev) < t["cond_image_dropout"],
                        "eps": n(b, f, h, h, 4),
                        "t": torch.randint(0, 1000, (b,), generator=gen, device=dev)})
        return out

    def step(self, record: bool = False) -> dict:
        """One optimizer step on this rank; the wait for the loader and the
        step's seconds, its loss, and with ``record`` the batch kept for the
        check and this rank's part of the checked step's numbers."""
        t0 = time.perf_counter()
        host = next(self.loader)
        t1 = time.perf_counter()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        self.state, m = self.trainer.train_step(self.state, batch,
                                                draws=self.draws(self.steps_done))
        out = {"loss": m["train_loss"], "wait": t1 - t0, "seconds": time.perf_counter() - t0}
        self.steps_done += 1
        if record:
            self.batches.append({k: v.numpy().copy() for k, v in host.items()})
            out.update(self.first_step())
        return out

    def first_step(self) -> dict:
        """After the first step: the first gradient (Adam's first moment /
        (1 - b1)) of each leaf whose optimizer state this rank holds, as
        its norm and first elements, and a digest of every master."""
        opt = self.state.optimizer
        local = getattr(opt, "optim", opt).state
        b1 = self.t["betas"][0]
        grad = {}
        for name, p in self.state.params.items():
            st = local.get(p, {})
            if "exp_avg" in st:
                g = st["exp_avg"] / (1 - b1)
                grad[name] = (float(g.norm()), g.flatten()[:SAMPLE].double().cpu().tolist())
        return {"grad": grad,
                "masters": {n: digest(p) for n, p in self.state.params.items()}}

    def release(self):
        if self.loader is not None:
            self.loader.close()
            self.loader = None
        for name in ("trainer", "state", "models"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, draw_log, control: bool) -> dict:
        """This rank's part of the check: its batches rebuilt from the files
        (their largest gap to what it trained on), and the reference's first
        step over the global batch: its own microbatches in float32, the
        gradient and loss sums all-reduced in plain torch. Returns the gap,
        and the reference's loss and gradient (and the control's) where
        rank 0 asks for them."""
        import torch.distributed as dist

        strict_fp32()
        t = self.t
        data_root = tempfile.mkdtemp(prefix="bench_dp_ref_")
        try:
            write_shares(data_root, self.seed, t, self.world)
            ds = ref.PairDataset(share_dir(data_root, self.rank), t["frames"],
                                 np.random.RandomState(derive_seed(self.seed, "dataset", self.rank)
                                                       % 2 ** 32), **t["augmentation"])
            rebuilt = ref.batches(ds, t["accumulate"] * t["micro_batch"], t["prompt_type"],
                                  np.random.RandomState(derive_seed(self.seed, "batches", self.rank)
                                                        % 2 ** 32), t["checked_steps"])
        finally:
            shutil.rmtree(data_root, ignore_errors=True)
        data = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
                   for a, b in zip(self.batches, rebuilt) for k in a)
        out = {"data": data, "reference": self.reference_step(rebuilt[0], draw_log)}
        if control:
            with precision("fp8"):
                out["control"] = self.reference_step(rebuilt[0], draw_log)
        dist.barrier()
        return out

    def reference_step(self, batch: dict, draws) -> dict:
        """The reference's loss and gradient of the first step over every
        rank's microbatches: this rank's sums, all-reduced."""
        import torch.distributed as dist

        t, c, W, dev = self.t, self.cfg, self.weights, self.device
        ac = torch.as_tensor(ref.alphas_cumprod(), device=dev)
        motion = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in self.motion_init.items()}
        Wu = dict(W["unet"])
        Wu.update(motion)
        vl, vb = len(c["vae"]["ch_mult"]), c["vae"]["num_res_blocks"]
        keys = list(motion)
        g_sum = torch.zeros(sum(v.numel() for v in motion.values()) + 1, device=dev)
        accum, mb = t["accumulate"], t["micro_batch"]
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            d = draws[i]
            with torch.no_grad():
                ids = torch.as_tensor(batch["prompt_ids"][rows], device=dev)
                text = ref_v2v.clip_text(W["text"], ids, c["text"]["num_layers"],
                                         c["text"]["num_heads"])
                encode = lambda video, eps: ref_v2v.vae_sample(
                    W["vae"], video.reshape((-1,) + video.shape[2:]), eps, vl, vb).reshape(
                    video.shape[:2] + eps.shape[1:])
                inp = torch.as_tensor(batch["input_video"][rows], device=dev)
                edited = torch.as_tensor(batch["edited_video"][rows], device=dev)
                cond = encode(inp, d["enc_cond"])
                cond = torch.where(d["drop"].reshape(-1, 1, 1, 1, 1), 0.0, cond)
                x0 = encode(edited, d["enc_edit"]) * c["scale_factor"]
                a = ac[d["t"]].float().reshape(-1, 1, 1, 1, 1)
                xt = a.sqrt() * x0 + (1.0 - a).sqrt() * d["eps"]
            pred = ref_v2v.unet3d(Wu, c["unet"], torch.cat([xt, cond], dim=-1), d["t"], text, 0)
            loss = ((pred - d["eps"]) ** 2).mean()
            grads = torch.autograd.grad(loss, [motion[k] for k in keys])
            g_sum[:-1] += torch.cat([g.flatten() for g in grads])
            g_sum[-1] += loss.detach()
        dist.all_reduce(g_sum)
        g_sum /= accum * self.world
        if self.rank:
            return {}
        flat = g_sum[:-1].split([motion[k].numel() for k in keys])
        return {"loss": float(g_sum[-1]), "grad": {k: g.view_as(motion[k])
                                                    for k, g in zip(keys, flat)}}


def adam_first_step(grad: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor], lr: float,
                    betas) -> Dict[str, torch.Tensor]:
    """The motion parameters after Adam's first step from ``init``."""
    b1, b2 = betas
    out = {}
    for k, g in grad.items():
        m_hat, v_hat = (1 - b1) * g / (1 - b1), (1 - b2) * g * g / (1 - b2)
        out[k] = init[k].float() - lr * m_hat / (v_hat.sqrt() + 1e-8)
    return out


# --- rank 0: the driver ---------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, port: int, device: torch.device) -> None:
    import torch.distributed as dist

    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))


class Peers:
    """Ranks 1..R-1: their processes and sockets. ``ask`` sends every rank
    one command; ``answers`` waits for each one's answer, and raises where
    a rank has failed, exited or not answered in time."""

    def __init__(self, world: int, port: int, setup: dict, device: torch.device):
        self.procs, self.conns = [], []
        env = dict(os.environ)
        env.pop("CUDA_LAUNCH_BLOCKING", None)
        for r in range(1, world):
            mine, theirs = socket.socketpair()
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                 str(world), "--port", str(port), "--fd", str(theirs.fileno()),
                 "--device", device.type],
                pass_fds=(theirs.fileno(),), env=env, cwd=os.path.dirname(BENCH))
            theirs.close()
            conn = Connection(mine.detach())
            conn.send(setup)
            self.procs.append(proc)
            self.conns.append(conn)
        atexit.register(self.stop)

    def ask(self, *cmd) -> None:
        for conn in self.conns:
            conn.send(cmd)

    def answers(self, seconds: float = REPLY_S) -> List:
        out = []
        for r, (proc, conn) in enumerate(zip(self.procs, self.conns), start=1):
            deadline = time.monotonic() + seconds
            while not conn.poll(1.0):
                if proc.poll() is not None:
                    raise RuntimeError(f"rank {r} exited with code {proc.returncode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rank {r} has not answered in {seconds} s")
            ok, value = conn.recv()
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out.append(value)
        return out

    def stop(self) -> None:
        for conn in self.conns:
            try:
                conn.send(("stop",))
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self.conns, self.procs = [], []


class Driver(base.Driver):
    """Set-up, units and check of the data-parallel training cell."""

    unit = "step"
    fault: Optional[str] = None  # a name in FAULTS, planted on every rank

    def __init__(self, cell, seed: int, device="cuda", trace: bool = False):
        super().__init__(cell, seed, device, trace)
        self.world = cell.traffic["ranks"]
        self.peers: Optional[Peers] = None
        self.step_log: List[dict] = []
        self.peer_wait: List[float] = []

    def setup(self):
        t = self.t
        dev = torch.device(self.device.type, 0) if self.device.type == "cuda" else self.device
        self.device = dev
        t0 = time.perf_counter()
        write_shares(self.root, self.seed, t, self.world)
        port = _free_port()
        setup = {"config": self.cfg, "traffic": t, "seed": self.seed, "root": self.root,
                 "fault": self.fault}
        self.peers = Peers(self.world, port, setup, dev)
        init_group(0, self.world, port, dev)
        if self.fault:
            owner, name, broken = FAULTS[self.fault]()
            setattr(owner, name, broken)
        self.rank = Rank(self.cfg, t, self.seed, 0, self.world, self.root, dev)
        self.rank.setup()
        self.weights, self.motion_init = self.rank.weights, self.rank.motion_init
        self.trainer, self.state = self.rank.trainer, self.rank.state
        self.peers.answers(READY_S)  # every rank ready before the first collective
        log(f"{self.world} ranks ready: weights, dataset ({t['samples']} pairs, "
            f"{t['samples'] // self.world} a rank), trainers: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        parts = [self._step(record=True) for _ in range(t["checked_steps"])]
        first = parts[0]
        grad = {}
        for part in first:
            grad.update(part["grad"])
        names = list(self.rank.state.params)
        missing = set(names) - set(grad)
        if missing:
            raise RuntimeError(f"{len(missing)} leaves have optimizer state on no rank")
        self.grad1 = {n: grad[n][0] for n in names}
        self.grad_sample = torch.cat([torch.tensor(grad[n][1]) for n in names]).to(dev)
        self.masters_gap = sum(part["masters"][n] != first[0]["masters"][n]
                               for part in first[1:] for n in names)
        self.change = {n: float((p - self.motion_init[n].float()).norm())
                       for n, p in self.rank.state.params.items()}
        self.draw_log = [self.rank.draws(0)]
        log(f"checked steps: {t['checked_steps']} in {time.perf_counter() - t0:.2f} s, "
            f"losses {self.losses}, masters differing {self.masters_gap}")

    def _step(self, record: bool = False) -> List[dict]:
        """One optimizer step on every rank: the others told first, then
        rank 0's own; the answers of all of them, rank 0's first."""
        self.peers.ask("step", record)
        mine = self.rank.step(record)
        t0 = time.perf_counter()
        theirs = self.peers.answers()
        self.peer_wait.append(time.perf_counter() - t0)
        self.losses.append(mine["loss"])
        self.spans["wait"] += mine["wait"]
        self.spans["step"] += mine["seconds"] + self.peer_wait[-1]
        self.steps_done += 1
        return [mine] + theirs

    def run_unit(self, k: int) -> int:
        if k == 0:
            self.spans = {"wait": 0.0, "step": 0.0}
            self.window_from = self.steps_done
        self._step()
        t = self.t
        return self.world * t["accumulate"] * t["micro_batch"] * t["frames"]

    def end_to_end(self, units: int, wall: float) -> Dict[str, float]:
        t = self.t
        frames = self.world * t["accumulate"] * t["micro_batch"] * t["frames"]
        return {"train_frames_per_s": units * frames / wall}

    def describe(self, units: int, wall: float) -> List[str]:
        from insv2v_torch.utils import tracing

        ms = [rec.host_ms for rec in tracing.records("train.all_reduce")]
        return super().describe(units, wall) + [
            f"{self.world} ranks; rank 0 waited {sum(self.peer_wait[-units:]):.3f} s for the "
            f"others' answers; train.all_reduce host ms (the enqueue) median "
            f"{float(np.median(ms)) if ms else float('nan'):.4f}"]

    # --- the traced run --------------------------------------------------------

    def readings(self, r: Readings, units: int, wall: float):
        """The training cell's readings over rank 0's profiled steps: one
        whole step with the device's activity, then ``HOST_MICRO``
        microbatches of the next with the host's ops. Every rank runs both
        steps whole (a step left half way would strand the others in its
        exchange)."""
        from counters import launch_counters
        from harness import Stretch
        from work.kernels import unet3d_launches

        t = self.t
        r.spans = dict(self.spans)
        r.counts = {"steps": units, "microbatches": units * t["accumulate"]}
        r.unit_wall_ms = 1e3 * self.spans["step"] / units
        r.flops_per_unit = self.flops_per_step()
        stretch = Stretch(launch_counters, t["accumulate"], HOST_MICRO)
        real = self.rank.trainer.microbatch_loss
        calls = [0]

        def marked(*a, **k):
            if calls[0] <= stretch.n + stretch.m:
                stretch.mark(calls[0])
            calls[0] += 1
            return real(*a, **k)

        self.rank.trainer.microbatch_loss = marked
        try:
            self._step()
            self._step()
        finally:
            self.rank.trainer.microbatch_loss = real
        stretch.fill(r)
        r.stretch_calls = 1
        per_micro = unet3d_launches(self.cfg["unet"], t["micro_batch"], t["frames"],
                                    t["size"] // 8, t["size"] // 8)
        r.work = {"ff": per_micro["ff"] * 2 * t["accumulate"]}
        log(f"profiled stretch: one step of rank 0 ({t['accumulate']} microbatches), "
            f"{len(r.trace.device_ops)} device ops, launches {r.launches}")

    # --- the check ---------------------------------------------------------------

    def release(self):
        """Drop the program's state on every rank; the ranks stay for the
        check."""
        if self.peers is not None:
            self.peers.ask("release")
            self.peers.answers()
        self.rank.release()
        for name in ("trainer", "state"):
            if hasattr(self, name):
                delattr(self, name)
        shutil.rmtree(self.root, ignore_errors=True)

    def check(self, control: bool = False):
        """{name: number} for the program and, with ``control``, for the
        reference one precision lower (fp8) in the program's place: the
        training cell's numbers over the global batch, ``data`` the largest
        gap of any rank's rebuilt batch, and ``masters``."""
        import torch.distributed as dist

        t = self.t
        try:
            self.peers.ask("check", control)
            mine = self.rank.check(self.draw_log[0], control)
            theirs = self.peers.answers()
        finally:
            self.peers.stop()
            if dist.is_initialized():
                dist.destroy_process_group()
        data = max(p["data"] for p in [mine] + theirs)
        init = self.motion_init
        run = lambda part: {"losses": [part["loss"]], "grad": part["grad"],
                            "params": adam_first_step(part["grad"], init, t["lr"], t["betas"])}
        got = {"losses": self.losses[:t["checked_steps"]], "grad": self.grad1,
               "change": self.change, "sample": self.grad_sample}
        prog = {"data": data, **self._numbers(got, run(mine["reference"])),
                "masters": float(self.masters_gap)}
        ctrl = {}
        if control:
            ctrl = {"data": 0.0, **self._numbers(self._summary(run(mine["control"])),
                                                 run(mine["reference"])), "masters": 0.0}
        return prog, ctrl


# --- ranks 1..R-1 ---------------------------------------------------------------------

def _watch_parent(ppid: int) -> None:
    """Exit at once when the process that started this rank is gone."""
    while True:
        if os.getppid() != ppid:
            os._exit(3)
        time.sleep(1.0)


def worker(args) -> int:
    conn = Connection(args.fd)
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    try:
        setup = conn.recv()
        dev = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
        init_group(args.rank, args.world, args.port, dev)
        if setup["fault"]:
            owner, name, broken = FAULTS[setup["fault"]]()
            setattr(owner, name, broken)
        rank = Rank(setup["config"], setup["traffic"], setup["seed"], args.rank, args.world,
                    setup["root"], dev)
        rank.setup()
        conn.send((True, "ready"))
        while True:
            cmd = conn.recv()
            if cmd[0] == "stop":
                break
            if cmd[0] == "step":
                conn.send((True, rank.step(record=cmd[1])))
            elif cmd[0] == "release":
                rank.release()
                conn.send((True, None))
            elif cmd[0] == "check":
                conn.send((True, rank.check(rank.draws(0), cmd[1])))
            else:
                raise ValueError(f"unknown command {cmd!r}")
    except EOFError:
        return 3
    except BaseException:
        try:
            conn.send((False, traceback.format_exc()))
        except (OSError, pickle.PicklingError):
            pass
        return 1
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank (1..R-1) of the data-parallel cell")
    for flag in ("--rank", "--world", "--port", "--fd"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--device", default="cuda")
    sys.exit(worker(ap.parse_args()))
