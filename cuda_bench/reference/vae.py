"""Plain AutoencoderKL of Stable Diffusion (the decoder runs; the encoder
holds its keys so that one state dict fills both sides), float32."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cuda_bench.reference.nn import FP32, GroupNorm, Precision, QConv2d, QLinear


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = QConv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = QConv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = QConv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    prec: Precision = FP32

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = QLinear(channels, channels)
        self.to_k = QLinear(channels, channels)
        self.to_v = QLinear(channels, channels)
        self.to_out = nn.ModuleList([QLinear(channels, channels)])

    def forward(self, x):
        b, c, hgt, wdt = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hgt * wdt, c)
        p = self.prec
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        probs = torch.softmax(torch.matmul(p.q(q), p.q(k).transpose(-1, -2)) / math.sqrt(c), dim=-1)
        h = self.to_out[0](torch.matmul(p.q(probs), p.q(v)))
        return x + h.reshape(b, hgt, wdt, c).permute(0, 3, 1, 2)


class _Holder(nn.Module):
    pass


def _conv_holder(ch: int, stride: int = 1, padding: int = 1) -> nn.Module:
    m = _Holder()
    m.conv = QConv2d(ch, ch, 3, stride=stride, padding=padding)
    return m


def _mid(ch: int, g: int) -> nn.Module:
    m = _Holder()
    m.resnets = nn.ModuleList([VAEResnet(ch, ch, g), VAEResnet(ch, ch, g)])
    m.attentions = nn.ModuleList([VAEAttention(ch, g)])
    return m


class AutoencoderKL(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int, norm_num_groups: int,
                 latent_channels: int = 4, in_channels: int = 3, out_channels: int = 3):
        super().__init__()
        g = norm_num_groups
        dec = self.decoder = _Holder()
        ch = list(reversed(block_out_channels))
        dec.conv_in = QConv2d(latent_channels, ch[0], 3, padding=1)
        dec.mid_block = _mid(ch[0], g)
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            blk = _Holder()
            resnets = []
            for _ in range(layers_per_block + 1):
                resnets.append(VAEResnet(prev, out_ch, g))
                prev = out_ch
            blk.resnets = nn.ModuleList(resnets)
            if i != len(ch) - 1:
                blk.upsamplers = nn.ModuleList([_conv_holder(out_ch)])
            blocks.append(blk)
        dec.up_blocks = nn.ModuleList(blocks)
        dec.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        dec.conv_out = QConv2d(ch[-1], out_channels, 3, padding=1)
        self.post_quant_conv = QConv2d(latent_channels, latent_channels, 1)

        enc = self.encoder = _Holder()
        ch = list(block_out_channels)
        enc.conv_in = QConv2d(in_channels, ch[0], 3, padding=1)
        blocks, prev = [], ch[0]
        for i, out_ch in enumerate(ch):
            blk = _Holder()
            resnets = []
            for _ in range(layers_per_block):
                resnets.append(VAEResnet(prev, out_ch, g))
                prev = out_ch
            blk.resnets = nn.ModuleList(resnets)
            if i != len(ch) - 1:
                blk.downsamplers = nn.ModuleList([_conv_holder(out_ch, 2, 0)])
            blocks.append(blk)
        enc.down_blocks = nn.ModuleList(blocks)
        enc.mid_block = _mid(ch[-1], g)
        enc.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        enc.conv_out = QConv2d(ch[-1], latent_channels * 2, 3, padding=1)
        self.quant_conv = QConv2d(latent_channels * 2, latent_channels * 2, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents [B, h, w, 4] -> image [B, 8h, 8w, 3] in [-1, 1]."""
        dec = self.decoder
        h = dec.conv_in(self.post_quant_conv(z.float().permute(0, 3, 1, 2)))
        h = dec.mid_block.resnets[0](h)
        h = dec.mid_block.attentions[0](h)
        h = dec.mid_block.resnets[1](h)
        for blk in dec.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return dec.conv_out(F.silu(dec.conv_norm_out(h))).permute(0, 2, 3, 1)
