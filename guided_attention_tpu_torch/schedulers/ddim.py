"""DDIM scheduler as plain functions over a precomputed schedule.

Counterpart of the JAX package's ``schedulers/ddim.py``. The schedule is
built in float64 numpy and stored as float32 tensors; every update runs in
float32 whatever the model dtype (pipeline:529-531).

Stable Diffusion scheduler config (v1.x and v2.1-base share it):
  beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
  num_train_timesteps=1000, steps_offset=1, clip_sample=False,
  set_alpha_to_one=False, prediction_type="epsilon".

Noise never comes from a hidden source: ``renoise`` and the eta > 0 branch
of ``ddim_step`` take the standard-normal draw as a tensor argument.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DDIMSchedule:
    """Per-step schedule of one run, indexed by the loop step i (i=0 is the
    noisiest timestep). Tensors are float32 except ``timesteps`` (int64)."""

    timesteps: torch.Tensor  # training timesteps, descending
    alpha_prod: torch.Tensor  # alphas_cumprod[t_i]
    alpha_prod_prev: torch.Tensor  # alphas_cumprod[t_i - dt] (or final)
    sigmas: torch.Tensor  # sqrt((1-a)/a) at t_i (pipeline:887)
    # re-noise blend Bt = a_t / a_{t-dt}; 1 (no-op) when the previous
    # timestep would be <= 0 (pipeline:1048-1053)
    renoise_beta: torch.Tensor
    init_noise_sigma: float = 1.0
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"


def make_ddim_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    steps_offset: int = 1,
    set_alpha_to_one: bool = False,
    prediction_type: str = "epsilon",
    device: Any = "cuda",
) -> DDIMSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final_alpha = 1.0 if set_alpha_to_one else alphas_cumprod[0]

    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    timesteps = timesteps + steps_offset

    a_t = alphas_cumprod[timesteps]
    prev_t = timesteps - step_ratio
    a_prev = np.where(prev_t >= 0, alphas_cumprod[np.clip(prev_t, 0, None)], final_alpha)
    sigmas = np.sqrt((1.0 - a_t) / a_t)
    beta_rn = np.where(prev_t > 0, a_t / np.where(prev_t > 0, a_prev, 1.0), 1.0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DDIMSchedule(
        timesteps=torch.as_tensor(timesteps.copy(), device=device),
        alpha_prod=f32(a_t),
        alpha_prod_prev=f32(a_prev),
        sigmas=f32(sigmas),
        renoise_beta=f32(beta_rn),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def ddim_step(
    sched: DDIMSchedule,
    i: int,
    noise_pred: torch.Tensor,
    sample: torch.Tensor,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
):
    """One DDIM update x_t -> x_{t-1}; returns (prev_sample, pred_original).

    Matches diffusers DDIMScheduler.step with clip_sample=False. For eta > 0
    the variance is diffusers' _get_variance and ``noise`` (a standard-normal
    draw shaped like ``sample``) is required:
      var = (1-a_prev)/(1-a_t) * (1 - a_t/a_prev),  std = eta*sqrt(var)
      prev = sqrt(a_prev)*x0 + sqrt(1-a_prev-std^2)*eps + std*noise
    """
    a_t = sched.alpha_prod[i]
    a_prev = sched.alpha_prod_prev[i]
    b_t = 1.0 - a_t
    x0 = (sample - torch.sqrt(b_t) * noise_pred) / torch.sqrt(a_t)
    if eta > 0.0:
        if noise is None:
            raise ValueError("ddim_step with eta > 0 requires a noise tensor")
        variance = (1.0 - a_prev) / b_t * (1.0 - a_t / a_prev)
        std = eta * torch.sqrt(variance)
        direction = torch.sqrt(torch.clamp(1.0 - a_prev - std**2, min=0.0)) * noise_pred
        prev = torch.sqrt(a_prev) * x0 + direction + std * noise.float()
    else:
        prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * noise_pred
    return prev, x0


def renoise(sched: DDIMSchedule, i: int, latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Re-add noise to return x_{t-1} to noise level t ("time travel",
    reference pipeline:1046-1053): x <- sqrt(Bt)*x + sqrt(1-Bt)*eps with
    Bt = a_t / a_{t-dt}; identity when the previous timestep <= 0."""
    beta = sched.renoise_beta[i]
    x = latents.float()
    out = torch.sqrt(beta) * x + torch.sqrt(torch.clamp(1.0 - beta, min=0.0)) * noise.float()
    return out.to(latents.dtype)
