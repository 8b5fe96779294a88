"""Layers whose products run at a chosen precision, and norms in float32."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision:
    """``q(x)``: the operand as the product sees it. "fp32" leaves it;
    "fp8" rounds it to float8 e4m3 under one scale per tensor (its absolute
    maximum maps to 448), as an fp8 product with per-tensor scaling reads
    it, and returns it as float32; a gradient flows through the rounding
    unchanged."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.name == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())  # the rounded value; the gradient passes as through x


FP32 = Precision("fp32")


class QLinear(nn.Linear):
    prec: Precision = FP32

    def forward(self, x):
        p = self.prec
        return F.linear(p.q(x), p.q(self.weight), None if self.bias is None else self.bias.float())


class QConv2d(nn.Conv2d):
    prec: Precision = FP32

    def forward(self, x):
        p = self.prec
        return self._conv_forward(p.q(x), p.q(self.weight), None if self.bias is None else self.bias.float())


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)


def set_precision(module: nn.Module, prec: Precision) -> None:
    """Every product of ``module`` reads its operands through ``prec``."""
    for m in module.modules():
        if isinstance(m, (QLinear, QConv2d)) or hasattr(m, "prec"):
            m.prec = prec
