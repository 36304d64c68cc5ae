"""Motion-module trainer on one GPU.

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

The JAX trainer forces its UNet's split-skip up-block path off; the port
has only the concat path. Randomness: the five draws of a microbatch (the
two posterior normals ``enc_cond`` and ``enc_edit``, the cond-drop mask
``drop``, ``eps`` and ``t``) come from a ``torch.Generator`` or are handed
in through ``draws``, so a test can replay a JAX run's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from insv2v_torch.diffusion.schedules import DiffusionSchedule, add_noise
from insv2v_torch.models.vae import SD_SCALE_FACTOR
from insv2v_torch.training.quantized_adam import Adam8bit

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


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # float32 masters of the trainable parameters
    optimizer: torch.optim.Optimizer  # over the masters


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


def make_optimizer(cfg: TrainConfig, params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """Adam over ``params`` (the float32 masters): ``torch.optim.Adam``,
    whose update is optax's, or the int8-moment ``Adam8bit``."""
    if cfg.optimizer == "adam8bit":
        return Adam8bit(params, cfg.lr, betas=cfg.betas)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, cfg.lr, betas=cfg.betas, eps=1e-8)
    raise ValueError(f"optimizer {cfg.optimizer!r} unknown")


def _loss(pred, target, kind: str) -> torch.Tensor:
    err = pred.float() - target.float()
    return err.abs().mean() if kind == "l1" else (err * err).mean()


class Trainer:
    """The models and the step. A batch holds ``input_video`` and
    ``edited_video`` (accum * B, F, H, W, 3) in [-1, 1] and ``prompt_ids``
    (accum * B, 77); the step splits it into ``accum`` microbatches of B."""

    def __init__(self, unet, vae, text_encoder, cfg: TrainConfig = TrainConfig()):
        self.unet, self.vae, self.text_encoder = unet, vae, text_encoder
        self.cfg = cfg
        self.schedule = DiffusionSchedule.create(
            beta_schedule=cfg.beta_schedule, num_train_timesteps=cfg.num_train_timesteps,
            beta_start=cfg.beta_start, beta_end=cfg.beta_end)
        self.device = next(unet.parameters()).device

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
        return TrainState(0, masters, make_optimizer(self.cfg, list(masters.values())))

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

        inp = torch.as_tensor(micro["input_video"], device=dev)
        edited = torch.as_tensor(micro["edited_video"], device=dev)
        b, f = inp.shape[:2]
        with torch.no_grad():
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
        pred = self.unet(sample, t, text_emb)
        target = eps if cfg.prediction_type == "epsilon" else x0
        return _loss(pred, target, cfg.loss_type)

    def accumulate_grads(self, state: TrainState, batch: Mapping,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Sequence[Mapping]] = None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(mean loss, mean float32 gradient of each master) over the
        batch's ``accum`` microbatches."""
        accum = self.cfg.accumulate_grad_batches
        n = len(batch["prompt_ids"])
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        mb = n // accum
        params = dict(self.unet.named_parameters())
        train = [params[name] for name in state.params]
        g_sum = [torch.zeros_like(m) for m in state.params.values()]
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = self.microbatch_loss(micro, draws[i] if draws else None, generator)
            grads = torch.autograd.grad(loss, train, allow_unused=True,
                                        materialize_grads=True)
            for acc, g in zip(g_sum, grads):
                acc.add_(g.float())
            loss_sum += loss.detach()
        return loss_sum / accum, [g.div_(accum) for g in g_sum]

    def train_step(self, state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[Mapping]] = None) -> Tuple[TrainState, Dict]:
        """One optimizer step over the batch; updates ``state`` and the
        model's motion parameters in place."""
        loss, grads = self.accumulate_grads(state, batch, generator, draws)
        for master, g in zip(state.params.values(), grads):
            master.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        self.push_params(state)
        state.step += 1
        return state, {"train_loss": float(loss)}
