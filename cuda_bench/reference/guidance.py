"""The guidance loss of one sample and the latent updates, float32.

Loss: the layers' head-mean cross maps at R x R are averaged, re-softmaxed
over the valid token slots (x100), smoothed by the 3x3 kernel
exp(-((x - m) / (2 sigma))^2) with reflect padding; per bound token, mass
inside and outside its box and the centring of its mass; per sub-prompt
group the sum of 0.2 * inside + 0.2 * 3 * outside + 0.05 * centring (BOX)
or the centring (COOR). The unscaled group loss (inside + outside, or the
centring) decides the thresholds.

The centring is a sum of absolute values, which has a kink where a map's
centre of mass meets its target in a coordinate. There the gradient is
either side's; ``flip`` takes the other side's for the terms it marks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cuda_bench.reference.text import BOX, COOR, Spec


def smoothing_kernel(kernel_size: int, sigma: float) -> torch.Tensor:
    grid = np.arange(kernel_size, dtype=np.float64)
    a = np.exp(-(((grid - (kernel_size - 1) / 2.0) / (2.0 * sigma)) ** 2))
    k = np.multiply.outer(a, a)
    return torch.as_tensor((k / k.sum()).astype(np.float32))


def smooth(maps: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """[K, R, R] -> [K, R, R], each map blurred on its own."""
    pad = (kernel_size - 1) // 2
    x = F.pad(maps[:, None], (pad,) * 4, mode="reflect")
    k = smoothing_kernel(kernel_size, sigma).to(maps.device)[None, None]
    return F.conv2d(x, k)[:, 0]


def centre_offsets(maps: torch.Tensor, spec: Spec, kernel_size: int = 3, sigma: float = 0.5):
    """(normalised maps f32[K, R, R], offsets f32[K, 2]): each token's
    centre of mass minus its target, column and row, in cells of the R x R
    grid."""
    R = spec.res
    logits = torch.where(spec.valid_text[None, None, :], maps.float() * 100.0, float("-inf"))
    probs = torch.softmax(logits, dim=-1).permute(2, 0, 1)  # [K, R, R]
    sm = smooth(probs, kernel_size, sigma)
    mass = sm.sum(dim=(1, 2), keepdim=True)
    ok = mass > 1e-12
    norm = torch.where(ok, sm / torch.where(ok, mass, torch.ones_like(mass)), 0.0)
    grid = torch.arange(R, dtype=torch.float32, device=maps.device) + 0.5
    col = (norm * grid[None, None, :]).sum(dim=(1, 2))
    row = (norm * grid[None, :, None]).sum(dim=(1, 2))
    return norm, torch.stack([col - spec.center_xy[:, 0] * R, row - spec.center_xy[:, 1] * R], dim=1)


def centred_tokens(spec: Spec) -> torch.Tensor:
    """bool[K]: the tokens whose loss holds a centring term."""
    return spec.token_mask & ((spec.ann_type == BOX) | (spec.ann_type == COOR))


def loss(maps: torch.Tensor, spec: Spec, inside_scale: float = 0.2, outside_scale: float = 0.2,
         center_weight: float = 0.05, kernel_size: int = 3, sigma: float = 0.5, flip=None):
    """maps f32[R, R, K] (mean over layers) -> (total, unscaled per group [G]).
    ``flip`` bool[K, 2] (column, row): centring terms taken on the other
    side of their kink, -|d| for |d|."""
    R = spec.res
    norm, off = centre_offsets(maps, spec, kernel_size, sigma)
    dist = off.abs() if flip is None else torch.where(flip, -off.abs(), off.abs())
    centring = (dist[:, 0] + 4.0 * dist[:, 1]) / (R - 1)
    inside = 1.0 - (norm * spec.inside_mask).sum(dim=(1, 2))
    outside = (norm * (1.0 - spec.inside_mask)).sum(dim=(1, 2))
    is_box = spec.token_mask & (spec.ann_type == BOX)
    is_coor = spec.token_mask & (spec.ann_type == COOR)
    scaled = torch.where(is_coor, centring, 0.0) + torch.where(
        is_box, inside_scale * inside + outside_scale * outside * 3.0 + center_weight * centring, 0.0)
    unscaled = torch.where(is_coor, centring, 0.0) + torch.where(is_box, inside + outside, 0.0)
    gid = torch.where(spec.token_mask, spec.subprompt_id, spec.n_groups)
    zeros = scaled.new_zeros(spec.n_groups + 1)
    total = zeros.index_add(0, gid, scaled)[:spec.n_groups].sum()
    groups = zeros.index_add(0, gid, unscaled)[:spec.n_groups]
    return total, groups
