"""Process groups, the transport between ranks, and the sharding policy of
the port's multi-process paths.

Counterpart of ``parallel/mesh.py`` in the JAX package. JAX builds one
``Mesh`` and GSPMD inserts the collectives its sharding annotations imply;
the port passes an explicit ``Group`` to the code that needs a collective
and calls it by hand:

  * data-parallel training (``training/trainer.py``): the float32
    gradient sum and loss sum all-reduced as one flat bucket, the
    optimizer state partitioned over ranks by whole tensors
    (``torch.distributed.optim.ZeroRedundancyOptimizer``), the updated
    masters broadcast from their owners;
  * frame-sharded inference (``frame_parallel``): the across-frame
    GroupNorm moments (``ops/norms.py``), one pair of all-to-alls per
    motion module (``models/unet3d.py``) and the sampler's ref deltas
    (``diffusion/samplers.py``).

``Group`` is the one transport. Under NCCL every collective takes CUDA
tensors as they are, and a host tensor (a few bytes of bookkeeping) goes
through the current card. Under gloo, which the rehearsals use (two ranks
on one card, or on the CPU), ``all_reduce`` and ``broadcast`` take CUDA
tensors as they are and ``all_gather`` and ``all_to_all``, which gloo does
not take on CUDA, are staged through pinned host buffers; the compute
stays on the device and an error in a collective propagates.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import datetime
import math
import os
import queue
import socket
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.optim import ZeroRedundancyOptimizer

__all__ = ["init_distributed", "world", "rank", "local_device", "Group", "same_on_all_ranks",
           "spawn", "shard_range", "local_batch_slice", "gather_optimizer_state",
           "assert_zero_sharded", "frame_parallel", "frame_group"]

# how long a rank waits for the others to join or to reach a collective
_TIMEOUT = datetime.timedelta(seconds=600)


def _default_backend(num_processes: int, device) -> str:
    """``nccl`` when this host has a GPU for each of its ranks, else gloo
    (ranks that share one card, or run on the CPU)."""
    dev = torch.device("cpu" if device is None else device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if dev.type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> bool:
    """Join a process group: a TCP store at ``coordinator`` (host:port).

    With no arguments the group comes from torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), which
    stands in for the TPU pod's auto-detection. ``backend`` defaults to
    ``nccl`` when each rank has its own GPU (``device`` is CUDA) and to
    ``gloo`` otherwise. Returns False, and joins nothing, for one process.
    """
    if coordinator is None and num_processes is None:
        env = os.environ
        missing = [k for k in ("MASTER_PORT", "RANK", "WORLD_SIZE") if k not in env]
        if missing:
            raise ValueError(f"no coordinator given and no launcher environment ({missing} unset)")
        coordinator = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if num_processes is None:
        raise ValueError(f"coordinator {coordinator} given without a number of processes")
    if num_processes <= 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process group needs a coordinator and a process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    dist.init_process_group(backend or _default_backend(num_processes, device),
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=_TIMEOUT)
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device) -> torch.device:
    """This rank's device: ``cuda`` is the rank's own card where each rank
    has one, else the one card the ranks share; the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank() % max(1, torch.cuda.device_count()))


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


class Group:
    """The ranks of the default process group and the transport between
    them. ``sent`` counts the bytes this rank sent, by collective (for
    all_reduce and broadcast the tensor's size, the volume of a ring or
    tree pass)."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("Group: no process group (call init_distributed first)")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.sent: Dict[str, int] = collections.Counter()

    def describe(self) -> str:
        if self.backend == "gloo":
            return (f"transport: gloo over {self.size} ranks; all_reduce and broadcast take "
                    f"CUDA tensors as they are, all_gather and all_to_all stage CUDA tensors "
                    f"through pinned host buffers")
        return (f"transport: {self.backend} over {self.size} ranks, CUDA tensors as they are, "
                f"host tensors through the current card")

    def _wire(self, t: torch.Tensor, gloo_on_host: bool) -> torch.Tensor:
        """``t`` where this backend's collective takes it: NCCL takes CUDA
        tensors only (a host tensor is copied to the current card); gloo's
        all_gather and all_to_all (``gloo_on_host``) take host tensors only
        (a CUDA tensor is staged through a pinned buffer)."""
        if self.backend == "nccl" and not t.is_cuda:
            return t.cuda()
        if self.backend == "gloo" and gloo_on_host and t.is_cuda:
            return _pinned_copy(t)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place; returns ``t``."""
        w = self._wire(t, gloo_on_host=False)
        dist.all_reduce(w)
        self.sent["all_reduce"] += t.numel() * t.element_size()
        return t if w is t else t.copy_(w)

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_sum(t).div_(self.size)

    def broadcast_from(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place; returns ``t``."""
        w = self._wire(t, gloo_on_host=False)
        dist.broadcast(w, src=src)
        if self.rank == src:
            self.sent["broadcast"] += t.numel() * t.element_size()
        return t if w is t else t.copy_(w)

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on ``t``'s device."""
        x = self._wire(t.contiguous(), gloo_on_host=True)
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x)
        self.sent["all_gather"] += (self.size - 1) * x.numel() * x.element_size()
        # a copy to the host must finish before the caller reads it
        return torch.cat(outs, dim=dim).to(t.device, non_blocking=t.is_cuda)

    def all_to_all_dims(self, t: torch.Tensor, split_dim: int, cat_dim: int,
                        cat_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Split ``t`` along ``split_dim`` into ``size`` parts
        (``tensor_split``'s sizes, the same on every rank), send part j to
        rank j, and concatenate what every rank sent along ``cat_dim`` in
        rank order. ``cat_sizes``: each rank's extent along ``cat_dim``
        (default: all equal to this rank's)."""
        split_dim, cat_dim = split_dim % t.ndim, cat_dim % t.ndim
        parts = [p.contiguous() for p in t.tensor_split(self.size, dim=split_dim)]
        cat_sizes = list(cat_sizes or [t.shape[cat_dim]] * self.size)
        shapes = []
        for i in range(self.size):
            s = list(t.shape)
            s[split_dim], s[cat_dim] = parts[self.rank].shape[split_dim], cat_sizes[i]
            shapes.append(s)
        send = self._wire(torch.cat([p.reshape(-1) for p in parts]), gloo_on_host=True)
        recv_sizes = [math.prod(s) for s in shapes]
        recv = torch.empty(sum(recv_sizes), dtype=t.dtype, device=send.device,
                           pin_memory=send.is_pinned())
        dist.all_to_all_single(recv, send, recv_sizes, [p.numel() for p in parts])
        self.sent["all_to_all"] += sum(p.numel() for i, p in enumerate(parts)
                                       if i != self.rank) * t.element_size()
        recv = recv.to(t.device, non_blocking=t.is_cuda)
        return torch.cat([r.view(s) for r, s in zip(recv.split(recv_sizes), shapes)],
                         dim=cat_dim)


def same_on_all_ranks(tensors: Sequence[torch.Tensor], group: Group) -> bool:
    """Whether every rank holds the same ``tensors`` (each one's float64
    sum, gathered from every rank and compared exactly; a collective)."""
    sums = torch.stack([t.detach().double().sum() for t in tensors])
    every = group.all_gather_dim(sums[None], 0)
    return bool((every == every[0]).all())


# --- processes --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(fn, rank_: int, world_: int, port: int, one_card_each: bool, args, results):
    try:
        if one_card_each:
            torch.cuda.set_device(rank_)
            init_distributed(f"127.0.0.1:{port}", world_, rank_, device=f"cuda:{rank_}")
        else:
            init_distributed(f"127.0.0.1:{port}", world_, rank_, backend="gloo")
        try:
            out = fn(Group(), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, out))
    except BaseException:  # the parent re-raises it with the traceback
        results.put((rank_, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_: int, *args, one_card_each: bool = False,
          timeout_s: float = 900.0) -> List:
    """Run ``fn(group, *args)`` in ``world_`` new processes joined into one
    group over localhost: gloo (on the CPU, or sharing the current GPU),
    or with ``one_card_each`` rank r on GPU r over NCCL. Returns each
    rank's result in rank order (they must pickle). ``fn`` is a
    module-level function (the processes start with a fresh interpreter
    and import it). A failure in any rank raises here with that rank's
    traceback, and every process is stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(fn, r, world_, port, one_card_each, args, results))
             for r in range(world_)]
    for p in procs:
        p.start()
    got: Dict[int, object] = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while len(got) < world_:
            try:
                r, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[i].exitcode for i in dead]} and no result")
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"spawn: no result after {timeout_s} s from ranks "
                                       f"{sorted(set(range(world_)) - set(got))}")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{out}")
            got[r] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world_)]


# --- data-parallel batch layout ----------------------------------------------

def shard_range(n: int, rank_: int, world_: int) -> slice:
    """Rank ``rank_``'s equal share ``[r*n/R, (r+1)*n/R)`` of ``n`` items."""
    if n % world_:
        raise ValueError(f"{n} items do not split evenly over {world_} ranks")
    per = n // world_
    return slice(rank_ * per, (rank_ + 1) * per)


def local_batch_slice(global_batch: Dict, accum: int, rank_: int, world_: int) -> Dict:
    """This rank's rows of a global batch of ``accum`` microbatches.

    The JAX step splits the GLOBAL batch into ``accum`` contiguous
    microbatches of ``mb`` rows and shards each over the data axis, so
    rank r's share of microbatch i is rows ``[i*mb + r*mb/R,
    i*mb + (r+1)*mb/R)``; the local batch is those shares in microbatch
    order, and the trainer's own split of it into ``accum`` microbatches
    gives each rank its share of each JAX microbatch."""
    n = len(next(iter(global_batch.values())))
    if n % (accum * world_):
        raise ValueError(f"a global batch of {n} does not split into {accum} microbatches "
                         f"over {world_} ranks")
    mb, per = n // accum, n // (accum * world_)
    idx = np.concatenate([np.arange(i * mb + rank_ * per, i * mb + (rank_ + 1) * per)
                          for i in range(accum)])
    return {k: v[idx] if isinstance(v, np.ndarray) else v[torch.as_tensor(idx)]
            for k, v in global_batch.items()}


# --- optimizer state sharded over ranks (ZeRO) -------------------------------

def _state_nbytes(state) -> int:
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(_state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(_state_nbytes(v) for v in state)
    return 0


def _state_bytes_by_param(optimizer) -> torch.Tensor:
    """(n,) bytes of optimizer state held here for each of the optimizer's
    n parameters; a ``ZeroRedundancyOptimizer`` holds its own shard's."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    local = optimizer.optim if isinstance(optimizer, ZeroRedundancyOptimizer) else optimizer
    out = torch.zeros(len(params), dtype=torch.float64)
    for p, st in local.state.items():
        out[index[id(p)]] = _state_nbytes(st)
    return out


def _on_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_host(v) for v in obj)
    return obj


def gather_optimizer_state(optimizer: ZeroRedundancyOptimizer, group: Group,
                           to: int = 0) -> Optional[dict]:
    """The unsharded optimizer's state dict (state keyed by the index among
    all parameters, on the host), gathered from every rank's shard on rank
    ``to``; None on the other ranks (a collective: every rank calls it).
    It loads into the sharded optimizer at any world size, and into a
    one-process one. ``ZeroRedundancyOptimizer.consolidate_state_dict``
    gathers the same, but it builds each shard's bytes with
    ``torch.ByteTensor(bytearray)``, ~100 s a GB on the host: 150 s more
    for the train CLI's two-rank Adam checkpoint (``chip_smoke.py``'s dp
    phase); ``gather_object`` takes seconds."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    local = optimizer.optim.state_dict()
    local_params = [p for g in optimizer.optim.param_groups for p in g["params"]]
    mine = {index[id(local_params[j])]: _on_host(v) for j, v in local["state"].items()}
    parts = [None] * group.size if group.rank == to else None
    dist.gather_object(mine, parts, dst=to)
    if group.rank != to:
        return None
    state = {}
    for part in parts:
        state.update(part)
    groups = [dict(lg, params=[index[id(p)] for p in g["params"]])
              for lg, g in zip(local["param_groups"], optimizer.param_groups)]
    return {"state": dict(sorted(state.items())), "param_groups": groups}


def assert_zero_sharded(optimizer, group: Group) -> Tuple[List[int], int]:
    """Check that the optimizer state really is sharded over the group (a
    collective: every rank calls it). Each rank's state bytes must be at
    most ``whole / world + the largest tensor's state`` and at least one
    rank must hold less than the whole; raises AssertionError otherwise,
    as for an optimizer replicated on every rank (a plain optimizer's
    parameters are the whole list). Returns (bytes on each rank, bytes of
    the whole state)."""
    per = group.all_gather_dim(_state_bytes_by_param(optimizer)[None], 0)
    whole = int(per.max(dim=0).values.sum())
    held = [int(x) for x in per.sum(dim=1)]
    largest = int(per.max())
    if whole == 0:
        raise AssertionError("no optimizer state on any rank (no step taken yet?)")
    over = [r for r, b in enumerate(held) if b > whole / group.size + largest]
    if over or min(held) >= whole:
        raise AssertionError(f"optimizer state not sharded over {group.size} ranks: bytes per "
                             f"rank {held} of a whole {whole} (largest tensor {largest})")
    return held, whole


# --- frame-sharded inference -------------------------------------------------

_FRAME_GROUP: contextvars.ContextVar = contextvars.ContextVar("insv2v_frame_group",
                                                              default=None)


@contextlib.contextmanager
def frame_parallel(group: Group):
    """Within the block, the video stream's frame axis (axis 1 of
    (B, F, H, W, C)) is sharded over ``group``: rank r holds frames
    ``[r*F/R, (r+1)*F/R)``, and the frame-coupled ops (across-frame
    GroupNorm, the motion modules, the sampler's ref deltas) exchange what
    they need. Inference only: the exchanges record no gradient. The
    counterpart of entering ``jax.set_mesh(mesh)`` with
    ``INSV2V_SP_AXIS`` naming the axis."""
    token = _FRAME_GROUP.set(group)
    try:
        yield group
    finally:
        _FRAME_GROUP.reset(token)


def frame_group() -> Optional[Group]:
    """The group of the enclosing ``frame_parallel`` block, or None."""
    return _FRAME_GROUP.get()
