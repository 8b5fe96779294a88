"""Shared building blocks: norms that compute in their own dtype, flax-style
random init, and the compute/norm dtype split.

The JAX package's modules run their norms in float32 (``norm_dtype``) and
everything else in the compute dtype; flax initializes dense and conv
kernels lecun-normal (truncated), biases to zero and norm scales to one.
The port follows both so that a random-init model at full depth keeps its
bf16 activations in the same range as the JAX package's.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in its parameters' dtype, whatever the input's."""

    def forward(self, x):
        return F.group_norm(x.to(self.weight.dtype), self.num_groups, self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in its parameters' dtype, whatever the input's."""

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight, self.bias, self.eps)


_NORMS = (GroupNorm, LayerNorm)


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std, by inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_flax_like_(module: nn.Module, generator: torch.Generator) -> None:
    """flax defaults: lecun-normal kernels (truncated normal, variance
    1/fan_in), zero biases, unit norm scales, embeddings N(0, 1/dim)."""
    # flax's truncated lecun-normal rescales by the std of a unit normal
    # truncated at +-2, so the variance is exactly 1/fan_in
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            _trunc_normal_(m.weight, math.sqrt(1.0 / fan_in) / trunc_std, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, math.sqrt(1.0 / m.weight.shape[1]), generator=generator)
        elif isinstance(m, _NORMS):
            m.weight.fill_(1.0)
            m.bias.zero_()


def cast_(module: nn.Module, dtype: torch.dtype, norm_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Compute layers in ``dtype``, norms in ``norm_dtype``; no gradients for
    parameters (only latents or deep features are ever differentiated)."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, _NORMS):
            m.to(norm_dtype)
    module.requires_grad_(False)
    return module
