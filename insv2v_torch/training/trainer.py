"""Motion-module trainer, on one GPU or data-parallel over several ranks.

Counterpart of ``training/trainer.py`` in the JAX package:

  * only the parameters of the motion modules train: the names that hold
    ``motion_modules.`` in the reference key layout (the JAX package
    matches its Flax module name ``motion_modules_``);
  * mixed precision by master weights: the model computes in its own
    dtype (bf16 on the GPU, as every kernel wants it); the trainer keeps
    float32 masters of the motion parameters, sums each microbatch's
    gradients in float32, steps the masters and copies them back into the
    model. This is the arithmetic of the JAX package's bf16 compute on f32
    motion parameters (``cast_frozen_to_bf16``);
  * gradient accumulation is a Python loop over microbatches (the JAX
    ``lax.scan``), with the mean loss and the mean gradient;
  * each microbatch runs the reference preprocessing (JAX
    ``_microbatch_loss``): frozen CLIP and VAE without gradients, sampled
    VAE encodes of both videos, the cond latent UNSCALED with a 10 % share
    of the batch dropped to zero, x0 scaled by 0.18215, t uniform in
    [0, T), q-sample, channel concat; epsilon or sample target.

Data parallelism (``Trainer(..., group=)``, the JAX trainer's dp mesh
with ZeRO-2): each rank runs its share of every microbatch
(``parallel.dist.local_batch_slice``), the float32 gradient sum and loss
sum are all-reduced as one flat bucket and divided by ``accum * R``, and
the optimizer state is partitioned over the ranks by whole tensors
(``torch.distributed.optim.ZeroRedundancyOptimizer``, greedy by size):
each rank steps the masters it owns and broadcasts them, then every rank
copies the masters into its model. Whole tensors, because ``Adam8bit``
quantizes each flattened tensor in blocks of 256: slicing a tensor across
ranks would move its block boundaries, and so its numbers.
``TrainConfig.compute_dtype`` runs the step under autocast, for a model
stored in float32 and computed in bf16 (the JAX CLI's ``--frozen-f32``).

The trainer's UNet calls take the concat up-block path
(``split_skip=False``), as the JAX trainer pins it; the split-skip path
is the inference default and computes the same function. Randomness: the
five draws of a microbatch (the two posterior normals ``enc_cond`` and
``enc_edit``, the cond-drop mask ``drop``, ``eps`` and ``t``) come from a
``torch.Generator`` or are handed in through ``draws``, so a test can
replay a JAX run's draws.

CUDA graphs (``models/graphed_call.py``, backward mode). On a CUDA
device the UNet's training call and its backward to the motion
parameters, remat's reruns and ``KernelGrad``'s twin recomputes inside
it, are replayed from CUDA graphs captured at the first microbatch of
each key (span ``train.graph_capture``; each forward replay is a
``train.graph_replay``): the host launches two graphs a microbatch where
it dispatched the forward and the backward op by op. What stays eager,
and why: the encodes, the draws, ``add_noise`` and the cond drop (they
draw from the generator, and no RNG runs inside a capture), the loss, the
per-leaf accumulation, the all-reduce, the optimizer and ``push_params``
(its in-place copy is what the next replay reads). The capturing
microbatch's launch counts and seconds hold the capture's warm-up (one
eager forward and backward). The prediction and the gradients are the
graphs' static buffers: a microbatch's backward runs, and its gradients
are added into the accumulators, before the next microbatch's forward, as
``accumulate_grads`` does. On the CPU, and where a module hook or a
stack's own span needs the model's Python, the call is the model's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from insv2v_torch.diffusion.schedules import DiffusionSchedule, add_noise
from insv2v_torch.models.graphed_call import graphed_call
from insv2v_torch.models.vae import SD_SCALE_FACTOR
from insv2v_torch.parallel.dist import Group
from insv2v_torch.training.quantized_adam import Adam8bit
from insv2v_torch.utils.tracing import span

__all__ = ["TrainConfig", "TrainState", "motion_param_mask", "cast_frozen_to_bf16",
           "make_optimizer", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    optimizer: str = "adam"  # adam | adam8bit
    loss_type: str = "l2"  # l1 | l2
    prediction_type: str = "epsilon"  # epsilon | sample
    cond_image_dropout: float = 0.1
    scale_factor: float = SD_SCALE_FACTOR
    accumulate_grad_batches: int = 1
    trainable_pattern: str = "motion_modules."
    beta_schedule: str = "scaled_linear"
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    # None: compute in the models' own dtype; "bfloat16": autocast to it
    # (models stored in float32 on the GPU)
    compute_dtype: Optional[str] = None


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # float32 masters of the trainable parameters
    # over the masters; sharded over the ranks under data parallelism
    optimizer: torch.optim.Optimizer


def motion_param_mask(params: Mapping[str, torch.Tensor],
                      pattern: str = TrainConfig.trainable_pattern) -> Dict[str, bool]:
    """True for the trainable names (those holding ``pattern``)."""
    return {name: pattern in name for name in params}


def cast_frozen_to_bf16(params: Mapping[str, torch.Tensor],
                        pattern: str = TrainConfig.trainable_pattern) -> Dict[str, torch.Tensor]:
    """Frozen floating tensors in bf16, trainable ones as they are: the
    stored form of a training run's UNet weights."""
    mask = motion_param_mask(params, pattern)
    return {k: v if mask[k] or not v.is_floating_point() else v.to(torch.bfloat16)
            for k, v in params.items()}


def make_optimizer(cfg: TrainConfig, params: Sequence[torch.Tensor],
                   group: Optional[Group] = None) -> torch.optim.Optimizer:
    """Adam over ``params`` (the float32 masters): ``torch.optim.Adam``,
    whose update is optax's, or the int8-moment ``Adam8bit``. With a
    ``group``, its state is partitioned over the ranks by whole tensors."""
    if cfg.optimizer == "adam8bit":
        cls, kw = Adam8bit, dict(lr=cfg.lr, betas=cfg.betas)
    elif cfg.optimizer == "adam":
        cls, kw = torch.optim.Adam, dict(lr=cfg.lr, betas=cfg.betas, eps=1e-8)
    else:
        raise ValueError(f"optimizer {cfg.optimizer!r} unknown")
    if group is None:
        return cls(params, **kw)
    return ZeroRedundancyOptimizer(params, optimizer_class=cls, **kw)


def _loss(pred, target, kind: str) -> torch.Tensor:
    err = pred.float() - target.float()
    return err.abs().mean() if kind == "l1" else (err * err).mean()


class Trainer:
    """The models and the step. A batch holds ``input_video`` and
    ``edited_video`` (accum * B, F, H, W, 3) in [-1, 1] and ``prompt_ids``
    (accum * B, 77); the step splits it into ``accum`` microbatches of B.
    With a ``group`` of R ranks the batch is this rank's local batch
    (``local_batch_slice``) and the step's numbers are the global batch's."""

    def __init__(self, unet, vae, text_encoder, cfg: TrainConfig = TrainConfig(),
                 group: Optional[Group] = None):
        self.unet, self.vae, self.text_encoder = unet, vae, text_encoder
        self.cfg = cfg
        self.group = group
        self.schedule = DiffusionSchedule.create(
            beta_schedule=cfg.beta_schedule, num_train_timesteps=cfg.num_train_timesteps,
            beta_start=cfg.beta_start, beta_end=cfg.beta_end)
        self.device = next(unet.parameters()).device
        # the training call, replayed from CUDA graphs on a CUDA device
        self.unet_call = functools.partial(graphed_call, unet,
                                           functools.partial(unet, split_skip=False),
                                           span_prefix="train", backward=True)

    # --- state --------------------------------------------------------------

    def create_state(self) -> TrainState:
        """Freeze everything but the motion parameters (motion modules in
        train mode, the rest in eval mode) and take their float32 masters."""
        pattern = self.cfg.trainable_pattern
        for m in (self.vae, self.text_encoder):
            m.eval().requires_grad_(False)
        self.unet.eval()
        for name, mod in self.unet.named_modules():
            if pattern in name + ".":
                mod.train()
        params = dict(self.unet.named_parameters())
        mask = motion_param_mask(params, pattern)
        for name, p in params.items():
            p.requires_grad_(mask[name])
        masters = {n: p.detach().float().clone() for n, p in params.items() if mask[n]}
        if not masters:
            raise ValueError(f"no UNet parameter matches {pattern!r}")
        return TrainState(0, masters, make_optimizer(self.cfg, list(masters.values()),
                                                     self.group))

    def compute(self):
        """The context the models compute in: autocast to
        ``cfg.compute_dtype`` where one is set, else nothing."""
        if self.cfg.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=getattr(torch, self.cfg.compute_dtype))

    def push_params(self, state: TrainState) -> None:
        """Copy the masters into the model's parameters (its dtype)."""
        params = dict(self.unet.named_parameters())
        with torch.no_grad():
            for name, master in state.params.items():
                params[name].copy_(master)

    # --- step ---------------------------------------------------------------

    def microbatch_loss(self, micro: Mapping, draws: Optional[Mapping] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The loss of one microbatch (a float32 scalar with a graph to the
        motion parameters). ``draws`` overrides any of the five draws."""
        cfg, dev = self.cfg, self.device
        given = dict(draws or {})

        def draw(key, make):
            return torch.as_tensor(given[key], device=dev) if key in given else make()

        with span("train.encode"):
            inp = torch.as_tensor(micro["input_video"], device=dev)
            edited = torch.as_tensor(micro["edited_video"], device=dev)
            b, f = inp.shape[:2]
            with torch.no_grad(), self.compute():
                text_emb = self.text_encoder(torch.as_tensor(micro["prompt_ids"], device=dev))

                def encode(video, key):
                    post = self.vae.posterior(video.reshape((b * f,) + video.shape[2:]))
                    eps = draw(key, lambda: torch.randn(post.mean.shape, generator=generator,
                                                        device=dev))
                    z = post.sample(eps)
                    return z.reshape((b, f) + z.shape[1:])

                # cond latent: unscaled, a cond_image_dropout share dropped to zero
                cond = encode(inp, "enc_cond")
                drop = draw("drop", lambda: torch.rand(b, generator=generator, device=dev)
                            < cfg.cond_image_dropout)
                cond = torch.where(drop.reshape(b, 1, 1, 1, 1), 0.0, cond)
                # the diffused target latent: scaled, q-sampled
                x0 = encode(edited, "enc_edit") * cfg.scale_factor
                eps = draw("eps", lambda: torch.randn(x0.shape, generator=generator, device=dev))
                t = draw("t", lambda: torch.randint(0, self.schedule.num_train_timesteps, (b,),
                                                    generator=generator, device=dev))
                sample = torch.cat([add_noise(self.schedule, x0, eps, t), cond], dim=-1)
        with span("train.forward"):
            with self.compute():
                pred = self.unet_call(sample, t, text_emb)
            target = eps if cfg.prediction_type == "epsilon" else x0
            return _loss(pred, target, cfg.loss_type)

    def accumulate_grads(self, state: TrainState, batch: Mapping,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Sequence[Mapping]] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(mean loss, mean float32 gradient of each master) over the
        batch's ``accum`` microbatches, and over the group's ranks: the
        gradient sums and the loss sum live in one flat float32 bucket,
        all-reduced once."""
        accum = self.cfg.accumulate_grad_batches
        n = len(batch["prompt_ids"])
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        params = dict(self.unet.named_parameters())
        train = [params[name] for name in state.params]
        masters = list(state.params.values())
        bucket = torch.zeros(sum(m.numel() for m in masters) + 1, device=self.device)
        g_sum = [g.view_as(m) for g, m in zip(bucket[:-1].split([m.numel() for m in masters]),
                                               masters)]
        loss_sum = bucket[-1]
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = self.microbatch_loss(micro, draws[i] if draws else None, generator)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, train, allow_unused=True,
                                            materialize_grads=True)
            with span("train.accumulate"):
                for acc, g in zip(g_sum, grads):
                    acc.add_(g.float())
                loss_sum += loss.detach()
        if self.group is not None:
            with span("train.all_reduce"):
                self.group.all_reduce_mean(bucket)
        bucket.div_(accum)
        return loss_sum, g_sum

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[Mapping]] = None) -> Tuple[TrainState, Dict]:
        """One optimizer step over the batch; updates ``state`` and the
        model's motion parameters in place. Its spans (``train.*``) carry the
        step number as their unit."""
        with span("train.step", unit=state.step):
            loss, grads = self.accumulate_grads(state, batch, generator, draws)
            with span("train.optimizer"):
                for master, g in zip(state.params.values(), grads):
                    master.grad = g
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
            with span("train.push_params"):
                self.push_params(state)
            state.step += 1
            with span("train.loss_sync"):
                loss = float(loss)
        return state, {"train_loss": loss}
