"""Gaussian smoothing of token attention maps.

The reference's kernel formula is ``exp(-((x - m) / (2*sigma))**2)``, an
effective std of sqrt(2)*sigma rather than the textbook gaussian (reference
utils/gaussian_smoothing.py:39-40); it is reproduced exactly, with reflect
padding as at the reference's call site (pipeline_guided_attention.py:251-254).

The blur is a weighted sum of shifted slices rather than a convolution, so
it is exact float32 whatever the cuDNN TF32 setting is. The reflect padding
is built from slices and ``torch.cat`` too: the backward of
``F.pad(mode="reflect")`` on CUDA accumulates with atomics, so the guidance
eval's latent gradient, and with it a guided image, differed from run to
run on the card (``python -m guided_attention_tpu_torch.determinism``). The
backward of slices and ``cat`` has no atomics.
"""
from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel(kernel_size: int = 3, sigma: float = 0.5, dim: int = 2) -> np.ndarray:
    """Separable product kernel with the reference's formula, normalized to 1."""
    axes = []
    for _ in range(dim):
        grid = np.arange(kernel_size, dtype=np.float64)
        mean = (kernel_size - 1) / 2.0
        axes.append(
            1.0 / (sigma * np.sqrt(2.0 * np.pi)) * np.exp(-(((grid - mean) / (2.0 * sigma)) ** 2))
        )
    kernel = axes[0]
    for a in axes[1:]:
        kernel = np.multiply.outer(kernel, a)
    kernel = kernel / kernel.sum()
    return kernel.astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``F.pad(x, (pad,) * 4, mode="reflect")`` of the last two axes, from
    slices (each edge row or column mirrored, the edge itself not repeated)."""
    for dim in (-2, -1):
        n = x.shape[dim]
        lo = x.narrow(dim, 1, pad).flip(dim)
        hi = x.narrow(dim, n - 1 - pad, pad).flip(dim)
        x = torch.cat([lo, x, hi], dim=dim)
    return x


def smooth_maps(maps: torch.Tensor, kernel_size: int = 3, sigma: float = 0.5) -> torch.Tensor:
    """Depthwise-smooth a stack of 2-D maps [..., H, W] with reflect padding
    ``(kernel_size-1)//2``; every leading axis is a channel."""
    k = gaussian_kernel(kernel_size, sigma, dim=2)
    pad = (kernel_size - 1) // 2
    shape = maps.shape
    h, w = shape[-2:]
    x = maps.reshape(-1, 1, h, w)
    if pad:
        x = reflect_pad(x, pad)
    out = None
    for a in range(kernel_size):
        for b in range(kernel_size):
            term = float(k[a, b]) * x[:, :, a : a + h, b : b + w]
            out = term if out is None else out + term
    return out.reshape(shape)
