"""DDIM (Stable Diffusion's scheduler: scaled-linear betas 0.00085-0.012
over 1000 steps, offset 1, epsilon prediction), re-noise, and the latent
updates of the guidance, float32."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Schedule:
    timesteps: np.ndarray  # int64[S], descending
    alpha: np.ndarray  # f64[S]
    alpha_prev: np.ndarray  # f64[S]
    renoise_beta: np.ndarray  # f64[S]


def schedule(steps: int, train_steps: int = 1000) -> Schedule:
    betas = np.linspace(0.00085**0.5, 0.012**0.5, train_steps, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ratio = train_steps // steps
    t = (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + 1
    prev = t - ratio
    a_prev = np.where(prev >= 0, ac[np.clip(prev, 0, None)], ac[0])
    return Schedule(t, ac[t], a_prev, np.where(prev > 0, ac[t] / np.where(prev > 0, a_prev, 1.0), 1.0))


def ddim(s: Schedule, i: int, eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    a, ap = float(s.alpha[i]), float(s.alpha_prev[i])
    x0 = (x.float() - (1.0 - a) ** 0.5 * eps.float()) / a**0.5
    return ap**0.5 * x0 + (1.0 - ap) ** 0.5 * eps.float()


def renoise(s: Schedule, i: int, x: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    b = float(s.renoise_beta[i])
    return b**0.5 * x.float() + max(1.0 - b, 0.0) ** 0.5 * draw.float()


def step_size(scale_factor: float, scale_range, steps: int, i: int) -> float:
    return float(scale_factor * np.sqrt(np.linspace(scale_range[0], scale_range[1], steps))[i])


def gradient_step(v: torch.Tensor, grad: torch.Tensor, lr: float) -> torch.Tensor:
    """v - lr * grad (a refinement step without the optimizer, and the
    gated update after the final eval)."""
    return v.float() - lr * grad.float()
