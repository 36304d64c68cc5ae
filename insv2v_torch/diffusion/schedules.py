"""Diffusion noise-schedule tables and reverse-step functions.

Counterpart of ``diffusion/schedules.py`` in the JAX package, with the
diffusers conventions the reference pins: ``scaled_linear`` betas; DDIM
with 'leading' spacing, ``steps_offset=1``, ``set_alpha_to_one=False``,
eta = 0; DDPM with the fixed-small posterior variance. Tables are computed
in float64 with numpy and kept as float32 numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["make_betas", "DiffusionSchedule", "SamplerTables", "make_sampler_tables",
           "ddim_step", "ddpm_step", "sampler_step"]


def make_betas(schedule: str, num_timesteps: int, beta_start: float = 1e-4,
               beta_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    if schedule in ("linear", "scaled_linear"):
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        ts = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule {schedule!r} unknown")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # (T,) float32, as the JAX package stores it

    @classmethod
    def create(cls, beta_schedule: str = "scaled_linear", num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               **_ignored) -> "DiffusionSchedule":
        betas = make_betas(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(num_train_timesteps, np.cumprod(1.0 - betas).astype(np.float32))


@dataclasses.dataclass(frozen=True)
class SamplerTables:
    """Per-step tables of a (kind, num_steps) sampler, indexed by step i."""

    kind: str  # 'ddim' | 'ddpm'
    num_steps: int
    timesteps: np.ndarray  # (S,) int64, descending
    alpha_prod: np.ndarray  # (S,) float32, alpha-bar at t_i
    alpha_prod_prev: np.ndarray  # (S,) float32, alpha-bar at the step's target
    variance: np.ndarray  # (S,) float32, sigma_i^2 of the reverse kernel


def make_sampler_tables(schedule: DiffusionSchedule, num_steps: int, kind: str = "ddim",
                        eta: float = 0.0, steps_offset: int = 1) -> SamplerTables:
    ac = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    step_ratio = schedule.num_train_timesteps // num_steps
    ts = (np.arange(0, num_steps) * step_ratio).round()[::-1].astype(np.int64)
    if kind == "ddim":
        ts = ts + steps_offset
        prev_ts = ts - step_ratio
        alpha_prod = ac[ts]
        alpha_prod_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)], ac[0])
        variance = (eta ** 2) * ((1 - alpha_prod_prev) / (1 - alpha_prod)
                                 * (1 - alpha_prod / alpha_prod_prev))
    elif kind == "ddpm":
        prev_ts = ts - step_ratio
        alpha_prod = ac[ts]
        alpha_prod_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)], 1.0)
        variance = (1 - alpha_prod_prev) / (1 - alpha_prod) * (1 - alpha_prod / alpha_prod_prev)
        variance = np.clip(variance, 1e-20, None)
        variance[ts == 0] = 0.0  # no noise on the terminal step
    else:
        raise ValueError(f"sampler kind {kind!r} unknown")
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return SamplerTables(kind, num_steps, ts.copy(), f32(alpha_prod), f32(alpha_prod_prev),
                         f32(variance))


def _c(v: float) -> float:
    """A step coefficient rounded to float32, the tables' precision."""
    return float(np.float32(v))


def ddim_step(tables: SamplerTables, x_t: torch.Tensor, eps: torch.Tensor, i: int,
              noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM reverse step (arXiv 2010.02502 eq. 12) -> (x_prev, x0_hat)."""
    a_t = float(tables.alpha_prod[i])
    a_prev = float(tables.alpha_prod_prev[i])
    var = float(tables.variance[i])
    x_t, eps = x_t.float(), eps.float()
    x0 = (x_t - _c(math.sqrt(1.0 - a_t)) * eps) / _c(math.sqrt(a_t))
    x_prev = _c(math.sqrt(a_prev)) * x0 + \
        _c(math.sqrt(max(1.0 - a_prev - var, 0.0))) * eps
    if noise is not None and var > 0:
        x_prev = x_prev + _c(math.sqrt(var)) * noise
    return x_prev, x0


def ddpm_step(tables: SamplerTables, x_t: torch.Tensor, eps: torch.Tensor, i: int,
              noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral DDPM step, diffusers fixed-small variance."""
    a_t = float(tables.alpha_prod[i])
    a_prev = float(tables.alpha_prod_prev[i])
    var = float(tables.variance[i])
    beta_prod, beta_prod_prev = 1.0 - a_t, 1.0 - a_prev
    current_alpha = a_t / a_prev
    x_t, eps = x_t.float(), eps.float()
    x0 = (x_t - _c(math.sqrt(beta_prod)) * eps) / _c(math.sqrt(a_t))
    coef_x0 = _c(math.sqrt(a_prev) * (1.0 - current_alpha) / beta_prod)
    coef_xt = _c(math.sqrt(current_alpha) * beta_prod_prev / beta_prod)
    x_prev = coef_x0 * x0 + coef_xt * x_t
    if var > 0:
        x_prev = x_prev + _c(math.sqrt(var)) * noise
    return x_prev, x0


def sampler_step(tables: SamplerTables, x_t, eps, i: int, noise=None):
    """Dispatch on the sampler kind. ``noise`` is read only when the step's
    variance is non-zero (never for eta = 0 DDIM)."""
    if tables.kind == "ddim":
        return ddim_step(tables, x_t, eps, i, noise)
    return ddpm_step(tables, x_t, eps, i, noise)
