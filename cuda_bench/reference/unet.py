"""Plain UNet2DCondition of Stable Diffusion 1.x / 2.1-base, float32.

Module names equal the diffusers checkpoint keys. ``forward(sample NHWC,
t, context, capture_res, truncate)`` returns (eps NHWC or None, the
head-mean cross-attention maps [B, Nq, 77] of every layer at
``capture_res``). With ``truncate`` it stops after the last layer that
captures, the layers after it do not change the maps.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cuda_bench.reference.nn import FP32, GroupNorm, LayerNorm, Precision, QConv2d, QLinear


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: int = 0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = QLinear(cin, dim)
        self.linear_2 = QLinear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = QConv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = QLinear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = QConv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = QConv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    prec: Precision = FP32

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = QLinear(query_dim, inner, bias=False)
        self.to_k = QLinear(context_dim, inner, bias=False)
        self.to_v = QLinear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([QLinear(inner, query_dim)])

    def forward(self, x, context=None, capture=False):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, nq, c = q.shape
        hd = c // self.heads

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, hd).transpose(1, 2)

        p = self.prec
        scores = torch.matmul(p.q(split(q)), p.q(split(k)).transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(p.q(probs), p.q(split(v))).transpose(1, 2).reshape(b, nq, c)
        return self.to_out[0](out), (probs.mean(dim=1) if capture else None)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QLinear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), QLinear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, capture):
        x = x + self.attn1(self.norm1(x))[0]
        h, cross_map = self.attn2(self.norm2(x), context, capture)
        x = x + h
        return x + self.ff(self.norm3(x)), cross_map


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, groups: int, linear: bool):
        super().__init__()
        inner = heads * dim_head
        self.linear = linear
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        if linear:
            self.proj_in = QLinear(channels, inner)
            self.proj_out = QLinear(inner, channels)
        else:
            self.proj_in = QConv2d(channels, inner, 1)
            self.proj_out = QConv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(inner, context_dim, heads, dim_head)])

    def forward(self, x, context, capture: bool):
        b, c, hgt, wdt = x.shape

        def tokens(t):
            return t.permute(0, 2, 3, 1).reshape(b, hgt * wdt, t.shape[1])

        def nchw(t):
            return t.reshape(b, hgt, wdt, t.shape[-1]).permute(0, 3, 1, 2)

        h = self.norm(x)
        h = self.proj_in(tokens(h)) if self.linear else tokens(self.proj_in(h))
        h, cross_map = self.transformer_blocks[0](h, context, capture)
        h = nchw(self.proj_out(h)) if self.linear else self.proj_out(nchw(h))
        return h + x, cross_map


class _Conv(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, stride=stride, padding=1)


class _Block(nn.Module):
    def __init__(self, resnets, attentions, sampler_name: Optional[str] = None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], layers_per_block: int, cross_attention_dim: int,
                 num_heads: Sequence[int], attn_down: Sequence[bool], use_linear_projection: bool,
                 norm_num_groups: int, in_channels: int = 4, out_channels: int = 4):
        super().__init__()
        boc = list(block_out_channels)
        self.n_blocks = n = len(boc)
        self.layers_per_block = layers_per_block
        self.attn_down = list(attn_down)
        c0 = boc[0]
        temb_dim = c0 * 4
        g = norm_num_groups

        def tf(ch, heads):
            return Transformer2D(ch, cross_attention_dim, heads, ch // heads, g, use_linear_projection)

        self.time_embedding = TimestepEmbedding(c0, temb_dim)
        self.conv_in = QConv2d(in_channels, c0, 3, padding=1)
        skip_ch, ch, down = [c0], c0, []
        for i, out_ch in enumerate(boc):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_dim, g))
                ch = out_ch
                if attn_down[i]:
                    attns.append(tf(out_ch, num_heads[i]))
                skip_ch.append(ch)
            if i != n - 1:
                down.append(_Block(resnets, attns, "downsamplers", _Conv(out_ch, 2)))
                skip_ch.append(ch)
            else:
                down.append(_Block(resnets, attns))
        self.down_blocks = nn.ModuleList(down)
        mid = boc[-1]
        self.mid_block = _Block([ResnetBlock2D(mid, mid, temb_dim, g), ResnetBlock2D(mid, mid, temb_dim, g)],
                                [tf(mid, num_heads[-1])])
        up = []
        rev_attn, rev_heads = list(reversed(attn_down)), list(reversed(num_heads))
        for i, out_ch in enumerate(reversed(boc)):
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_ch.pop(), out_ch, temb_dim, g))
                ch = out_ch
                if rev_attn[i]:
                    attns.append(tf(out_ch, rev_heads[i]))
            if i != n - 1:
                up.append(_Block(resnets, attns, "upsamplers", _Conv(out_ch, 1)))
            else:
                up.append(_Block(resnets, attns))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(g, c0, eps=1e-5)
        self.conv_out = QConv2d(c0, out_channels, 3, padding=1)

    def forward(self, sample, timestep, context, capture_res: Optional[int] = None, truncate: bool = False):
        size = sample.shape[1]
        layer_res: List[int] = []  # resolution of each attention layer, in forward order
        for i in range(self.n_blocks):
            if self.attn_down[i]:
                layer_res += [size >> i] * self.layers_per_block
        layer_res.append(size >> (self.n_blocks - 1))
        for i, has in enumerate(reversed(self.attn_down)):
            if has:
                layer_res += [size >> (self.n_blocks - 1 - i)] * (self.layers_per_block + 1)
        hits = [k for k, r in enumerate(layer_res) if r == capture_res]
        stop_at = hits[-1] if (truncate and hits) else None
        maps: List[torch.Tensor] = []
        n_attn = 0

        def attend(blk_attn, h, ctx):
            nonlocal n_attn
            capture = h.shape[2] == capture_res
            h, m = blk_attn(h, ctx, capture)
            if m is not None:
                maps.append(m)
            n_attn += 1
            return h, stop_at is not None and n_attn - 1 == stop_at

        b = sample.shape[0]
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
        temb = self.time_embedding(timestep_embedding(t, self.conv_in.out_channels))
        ctx = context.float()
        h = self.conv_in(sample.float().permute(0, 3, 1, 2))
        res_samples = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if len(blk.attentions):
                    h, stop = attend(blk.attentions[j], h, ctx)
                    if stop:
                        return None, maps
                res_samples.append(h)
            if i != self.n_blocks - 1:
                h = blk.downsamplers[0].conv(h)
                res_samples.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h, stop = attend(self.mid_block.attentions[0], h, ctx)
        if stop:
            return None, maps
        h = self.mid_block.resnets[1](h, temb)
        for i, blk in enumerate(self.up_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, res_samples.pop()], dim=1), temb)
                if len(blk.attentions):
                    h, stop = attend(blk.attentions[j], h, ctx)
                    if stop:
                        return None, maps
            if i != self.n_blocks - 1:
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1), maps
