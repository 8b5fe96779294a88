"""UNet2DCondition with attention-map capture (counterpart of the JAX
package's ``models/unet.py``).

* ``forward`` returns ``(eps, aux)``: ``aux["maps"]`` holds the head-mean
  cross/self attention maps of every layer selected by ``capture`` (a set of
  ``(kind, resolution)`` pairs, kind in {"cross", "self", "cross_perhead"}),
  ``aux["deep"]`` the bottleneck residual; ``deep_inject`` replaces that
  residual for deep-feature optimization: one row per sample, each given
  to the sample's B/S consecutive rows (its CFG pair), and where
  ``deep_inject_gate`` (bool per sample) is False the sample keeps its own.
* paint-with-words enters as per-resolution masks plus a per-step gate.
* ``truncate=True`` stops after the last attention layer that captures
  anything (or after the down blocks when nothing is captured) and returns
  ``eps=None``: the guidance eval needs only the maps, and eager PyTorch does
  not drop dead layers the way XLA does for the JAX program.
* On the mesh's tensor axis (``parallel.mesh.shard_unet`` sets ``tp`` on
  the attention and feed-forward layers it shards) a layer runs its local
  heads, or its part of the feed-forward width, Megatron-style: f
  (``copy_to_tensor``) before the column-sharded projections, g
  (``reduce_from_tensor``) after the row-sharded one, its replicated bias
  added once, after g. The maps it returns are the whole layer's
  (``ops.attention``), so ``collect`` and the guidance see what one process
  sees.

Public tensors keep the JAX package's layouts: latents and deep features are
NHWC, maps [B, Nq, K] with queries in row-major (h, w) order. Inside, the
network runs NCHW. Module names equal the diffusers checkpoint keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from guided_attention_tpu_torch.models.layers import GroupNorm, LayerNorm
from guided_attention_tpu_torch.ops.attention import attention
from guided_attention_tpu_torch.parallel.tensor import TensorAxis, copy_to_tensor, reduce_from_tensor

CaptureSpec = FrozenSet[Tuple[str, int]]
EMPTY_CAPTURE: CaptureSpec = frozenset()


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # attention heads per block level (SD1.x: 8 everywhere; SD2.1: head_dim 64)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    # which down-block levels have cross-attention (SD: first 3 of 4)
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # the flash kernels for long self-attention sequences and captured cross
    use_flash_attention: bool = False
    flash_min_seq: int = 2048
    dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, freq_shift: int = 0):
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding), fp32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _to_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        dtype = self.conv1.weight.dtype
        h = F.silu(self.norm1(x)).to(dtype)
        h = self.conv1(h)
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(self.norm2(h)).to(dtype)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _row_sharded_out(linear: nn.Linear, x: torch.Tensor, tp: TensorAxis) -> torch.Tensor:
    """A projection whose weight holds this rank's input columns: the
    group's sum of the partial products (g), then the replicated bias."""
    return reduce_from_tensor(F.linear(x, linear.weight), tp) + linear.bias


class CrossAttention(nn.Module):
    tp: Optional[TensorAxis] = None  # set by parallel.mesh.shard_unet: this rank's heads of the layer

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None, capture=False, capture_perhead=False, pww_mask=None, pww_gate=None, use_flash=False):
        tp = self.tp
        if tp is not None:
            x = copy_to_tensor(x, tp)
            context = None if context is None else copy_to_tensor(context, tp)
        ctx = x if context is None else context
        out, pooled = attention(
            self.to_q(x),
            self.to_k(ctx),
            self.to_v(ctx),
            self.heads if tp is None else self.heads // tp.size,
            capture=capture,
            capture_perhead=capture_perhead,
            pww_mask=pww_mask,
            pww_gate=pww_gate,
            use_flash=use_flash,
            tp=tp,
        )
        if tp is not None:
            return _row_sharded_out(self.to_out[0], out, tp), pooled
        return self.to_out[0](out), pooled


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        # [hidden; gate]: sharded, a rank's proj holds its slice of each half
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # diffusers GEGLU uses exact gelu


class FeedForward(nn.Module):
    tp: Optional[TensorAxis] = None  # set by parallel.mesh.shard_unet: this rank's part of the width

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        if self.tp is not None:
            return _row_sharded_out(self.net[2], self.net[0](copy_to_tensor(x, self.tp)), self.tp)
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)  # flax LayerNorm default epsilon
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, capture_self, capture_cross, capture_cross_ph, pww_mask, pww_gate, flash_self, flash_cross):
        dtype = x.dtype
        h, self_map = self.attn1(self.norm1(x).to(dtype), None, capture=capture_self, use_flash=flash_self)
        x = x + h
        h, cross_map = self.attn2(
            self.norm2(x).to(dtype),
            context,
            capture=capture_cross,
            capture_perhead=capture_cross_ph,
            pww_mask=pww_mask,
            pww_gate=pww_gate,
            use_flash=flash_cross,
        )
        x = x + h
        x = x + self.ff(self.norm3(x).to(dtype))
        return x, self_map, cross_map


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> block -> proj_out -> +residual."""

    def __init__(self, channels: int, context_dim: int, heads: int, dim_head: int, groups: int, linear: bool):
        super().__init__()
        inner = heads * dim_head
        self.linear = linear
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        if linear:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv2d(channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(inner, context_dim, heads, dim_head)])

    def forward(self, x, context, capture: CaptureSpec, pww, pww_gate, flash_self: bool, flash_cross: bool):
        b, c, hgt, wdt = x.shape
        res = hgt
        pww_mask = pww.get(res) if pww else None
        residual = x
        h = self.norm(x).to(x.dtype)
        if self.linear:
            h = self.proj_in(_to_tokens(h))
        else:
            h = _to_tokens(self.proj_in(h))
        h, self_map, cross_map = self.transformer_blocks[0](
            h,
            context,
            ("self", res) in capture,
            ("cross", res) in capture,
            ("cross_perhead", res) in capture,
            pww_mask,
            pww_gate,
            flash_self,
            flash_cross,
        )
        if self.linear:
            h = _to_nchw(self.proj_out(h), hgt, wdt)
        else:
            h = self.proj_out(_to_nchw(h, hgt, wdt))
        return h + residual, self_map, cross_map


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """Container with diffusers' ``resnets`` / ``attentions`` / sampler lists."""

    def __init__(self, resnets, attentions, sampler_name: Optional[str] = None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet2DCondition(nn.Module):
    """SD UNet. NHWC latents [B, H, W, 4] in; (eps NHWC or None, aux) out."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        boc = cfg.block_out_channels
        n = len(boc)
        c0 = boc[0]
        temb_dim = c0 * 4
        g = cfg.norm_num_groups
        ctx_dim = cfg.cross_attention_dim
        lin = cfg.use_linear_projection

        def tf(ch, heads):
            return Transformer2D(ch, ctx_dim, heads, ch // heads, g, lin)

        self.time_embedding = TimestepEmbedding(c0, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)

        skip_ch = [c0]
        ch = c0
        down = []
        for i, out_ch in enumerate(boc):
            resnets, attns = [], []
            for _j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_dim, g))
                ch = out_ch
                if cfg.attn_down[i]:
                    attns.append(tf(out_ch, cfg.num_heads[i]))
                skip_ch.append(ch)
            if i != n - 1:
                down.append(_Block(resnets, attns, "downsamplers", Downsample2D(out_ch)))
                skip_ch.append(ch)
            else:
                down.append(_Block(resnets, attns))
        self.down_blocks = nn.ModuleList(down)

        mid = boc[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid, mid, temb_dim, g), ResnetBlock2D(mid, mid, temb_dim, g)],
            [tf(mid, cfg.num_heads[-1])],
        )

        rev_ch = list(reversed(boc))
        rev_attn = list(reversed(cfg.attn_down))
        rev_heads = list(reversed(cfg.num_heads))
        up = []
        for i in range(n):
            out_ch = rev_ch[i]
            resnets, attns = [], []
            for _j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_ch.pop(), out_ch, temb_dim, g))
                ch = out_ch
                if rev_attn[i]:
                    attns.append(tf(out_ch, rev_heads[i]))
            if i != n - 1:
                up.append(_Block(resnets, attns, "upsamplers", Upsample2D(out_ch)))
            else:
                up.append(_Block(resnets, attns))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm(g, c0, eps=1e-5)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def _last_capture_layer(self, size: int, capture: CaptureSpec) -> int:
        """Forward-order index of the last attention layer that captures
        (-1 when none does)."""
        cfg = self.config
        n = len(cfg.block_out_channels)
        res_list: List[int] = []
        for i in range(n):
            if cfg.attn_down[i]:
                res_list += [size >> i] * cfg.layers_per_block
        res_list.append(size >> (n - 1))
        for i, has in enumerate(reversed(cfg.attn_down)):
            if has:
                res_list += [size >> (n - 1 - i)] * (cfg.layers_per_block + 1)
        captured = {r for _kind, r in capture}
        hits = [k for k, r in enumerate(res_list) if r in captured]
        return hits[-1] if hits else -1

    def forward(
        self,
        sample: torch.Tensor,  # [B, H, W, C_in]
        timestep,  # int, scalar or [B] tensor
        encoder_hidden_states: torch.Tensor,  # [B, K, ctx_dim]
        capture: CaptureSpec = EMPTY_CAPTURE,
        pww: Optional[Dict[int, torch.Tensor]] = None,
        pww_gate=None,
        deep_inject: Optional[torch.Tensor] = None,
        truncate: bool = False,
        deep_inject_gate: Optional[torch.Tensor] = None,
    ):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        maps: Dict[str, List[torch.Tensor]] = {
            f"{place}_{kind}": [] for place in ("down", "mid", "up") for kind in ("cross", "self", "cross_perhead")
        }
        stop_at = self._last_capture_layer(sample.shape[1], capture) if truncate else None
        n_attn = 0

        def collect(place, self_map, cross_map):
            nonlocal n_attn
            if self_map is not None:
                maps[f"{place}_self"].append(self_map)
            if cross_map is not None:
                key = "cross_perhead" if cross_map.dim() == 4 else "cross"
                maps[f"{place}_{key}"].append(cross_map)
            n_attn += 1
            return stop_at is not None and n_attn - 1 == stop_at

        b = sample.shape[0]
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))

        def flash_self(x):
            return cfg.use_flash_attention and x.shape[2] * x.shape[3] >= cfg.flash_min_seq

        n_blocks = len(cfg.block_out_channels)
        res_samples = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if len(blk.attentions):
                    h, sm, cm = blk.attentions[j](h, ctx, capture, pww, pww_gate, flash_self(h), cfg.use_flash_attention)
                    if collect("down", sm, cm):
                        return None, {"maps": maps, "deep": None}
                res_samples.append(h)
            if i != n_blocks - 1:
                h = blk.downsamplers[0](h)
                res_samples.append(h)

        deep = res_samples[-1]
        deep_nhwc = deep.permute(0, 2, 3, 1)
        if truncate and stop_at == -1:
            return None, {"maps": maps, "deep": deep_nhwc}
        if deep_inject is not None:
            inj = deep_inject.to(dtype).permute(0, 3, 1, 2)
            rows = b // inj.shape[0]
            inj = inj.repeat_interleave(rows, dim=0)
            if deep_inject_gate is not None:
                keep = deep_inject_gate.repeat_interleave(rows)[:, None, None, None]
                inj = torch.where(keep, inj, res_samples[-1])
            res_samples[-1] = inj

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h, sm, cm = mid.attentions[0](h, ctx, capture, pww, pww_gate, False, cfg.use_flash_attention)
        if collect("mid", sm, cm):
            return None, {"maps": maps, "deep": deep_nhwc}
        h = mid.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = torch.cat([h, res_samples.pop()], dim=1)
                h = resnet(h, temb)
                if len(blk.attentions):
                    h, sm, cm = blk.attentions[j](h, ctx, capture, pww, pww_gate, flash_self(h), cfg.use_flash_attention)
                    if collect("up", sm, cm):
                        return None, {"maps": maps, "deep": deep_nhwc}
            if i != n_blocks - 1:
                h = blk.upsamplers[0](h)

        h = F.silu(self.conv_norm_out(h)).to(dtype)
        h = self.conv_out(h)
        return h.permute(0, 2, 3, 1), {"maps": maps, "deep": deep_nhwc}
