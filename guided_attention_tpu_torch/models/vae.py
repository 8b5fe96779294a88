"""AutoencoderKL (the Stable Diffusion VAE), decoder and encoder,
counterpart of the JAX package's ``models/vae.py``.

Architecture (SD v1/v2 share it): block_out_channels (128, 256, 512, 512),
layers_per_block 2, GroupNorm(32, eps 1e-6) in float32, a single-head mid
attention, scaling_factor 0.18215. ``decode`` and ``encode`` take and
return NHWC, the JAX package's layout. The decoder is on the generation
path; the encoder completes the modules so that a diffusers checkpoint
loads whole (image-to-image entry points will use it).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from guided_attention_tpu_torch.models.layers import GroupNorm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hgt, wdt = x.shape
        dtype = self.to_q.weight.dtype
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hgt * wdt, c).to(dtype)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (float(c) ** 0.5)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        h = self.to_out[0](torch.matmul(probs, v))
        return x + h.reshape(b, hgt, wdt, c).permute(0, 3, 1, 2)


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample_ch=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample_ch is not None:
            self.upsamplers = nn.ModuleList([_Conv(upsample_ch)])


class _Conv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)


class _DownBlock(nn.Module):
    def __init__(self, resnets, downsample_ch=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample_ch is not None:
            self.downsamplers = nn.ModuleList([_StridedConv(downsample_ch)])


class _StridedConv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups), VAEResnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = list(reversed(cfg.block_out_channels))  # (512, 512, 256, 128)
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = _MidBlock(ch[0], g)
        blocks = []
        prev = ch[0]
        for i, out_ch in enumerate(ch):
            resnets = []
            for _j in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(prev, out_ch, g))
                prev = out_ch
            blocks.append(_UpBlock(resnets, out_ch if i != len(ch) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(z.to(dtype))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = F.silu(self.conv_norm_out(h)).to(dtype)
        return self.conv_out(h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks = []
        prev = ch[0]
        for i, out_ch in enumerate(ch):
            resnets = []
            for _j in range(cfg.layers_per_block):
                resnets.append(VAEResnet(prev, out_ch, g))
                prev = out_ch
            blocks.append(_DownBlock(resnets, out_ch if i != len(ch) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.latent_channels * 2, 3, padding=1)

    def forward(self, x):
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(x.to(dtype))
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                # diffusers pads asymmetrically (right and bottom) before the stride-2 conv
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        h = F.silu(self.conv_norm_out(h)).to(dtype)
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    """``decode(z)`` and ``encode(x)`` on NHWC tensors; module names equal
    diffusers' keys."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        # registered after the decoder's modules, so that a seeded random
        # init draws the decoder's weights as it did before the encoder
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(config.latent_channels * 2, config.latent_channels * 2, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents [B, h, w, 4] -> image [B, 8h, 8w, 3] in [-1, 1]."""
        x = z.to(self.post_quant_conv.weight.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(x)).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image [B, H, W, 3] in [-1, 1] -> (mean, logvar) of the latent
        posterior, each [B, H/8, W/8, 4]."""
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = torch.chunk(h, 2, dim=-1)
        return mean, logvar

    def forward(self, z):
        return self.decode(z)


def latents_to_images(decoded: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC -> [0,1] images, in the input dtype."""
    return torch.clamp(decoded / 2.0 + 0.5, 0.0, 1.0)
