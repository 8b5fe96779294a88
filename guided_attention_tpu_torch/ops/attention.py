"""Attention with map capture and paint-with-words biasing.

Counterpart of the JAX package's ``ops/attention.py``: the op returns the
head-averaged probability map beside the hidden states, so the UNet threads
maps up as outputs instead of writing a global store (reference
utils/ptp_utils.py:59-146).

Score math (ptp_utils.py:97-146):
  * scores = scale * q @ k^T in float32;
  * paint-with-words: scores += mask * 0.4 * max(scores) * gate. A mask
    [Q, K] takes the max over the whole [B, H, Q, K] score tensor; a mask
    per sample [S, Q, K] takes it per sample, over that sample's B/S
    consecutive rows (its CFG pair, or its one eval row), as the JAX
    package's does under ``vmap``, so that no sample's scores reach another
    sample's forward or gradient;
  * probs = softmax(scores) in float32, cast to the compute dtype for the
    probs @ v product; the captured map stays float32.

Routing to the kernels of ``ops/flash_attention.py`` under ``use_flash``:
K1/K2 only for self-attention without capture or pww, K3 only for captured
cross-attention without the per-head map or pww; everything else takes the
plain matmul path.

On the mesh's tensor axis (``tp``) the projections hold this rank's heads,
and both routes run on them as they are. What spans the heads is made
whole over the tensor group (``parallel/tensor.py``): the captured head
mean is the group's sum of (local mean x local heads) over all heads, the
per-head map is gathered, and the paint-with-words score max is the
group's max, so every rank holds the maps one process would.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from guided_attention_tpu_torch.ops.flash_attention import cross_attention_with_map, flash_attention
from guided_attention_tpu_torch.parallel.tensor import TensorAxis, gather_heads, reduce_from_tensor, tensor_amax


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    *,
    capture: bool = False,
    capture_perhead: bool = False,
    pww_mask: Optional[torch.Tensor] = None,
    pww_gate=None,
    use_flash: bool = False,
    tp: Optional[TensorAxis] = None,
    bwd_config: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-head attention over [B, N, C] projections.

    Args:
      q: [B, Nq, C]; k, v: [B, Nk, C] (C = heads * head_dim).
      capture: also return the head-mean probability map [B, Nq, Nk] (fp32).
      capture_perhead: return the un-pooled probs [B, H, Nq, Nk] instead.
      pww_mask: paint-with-words additive mask [Nq, Nk], or [S, Nq, Nk]
        for S samples of B/S consecutive rows each (or None).
      pww_gate: scalar = step_gate * log(1 + sigma_t) (or None).
      use_flash: allow the kernels (see the module docstring).
      tp: this rank's place on the tensor axis, whose group holds the other
        heads: ``heads`` and C count this rank's heads only, the maps
        returned are every head's.
      bwd_config: K2's tile configuration for the self-attention route's
        backward (``K2_TILE_CONFIGS`` index; None: its main one).

    Returns:
      (out [B, Nq, C] in q.dtype, probs map fp32 or None)
    """
    capture = capture or capture_perhead
    dtype = q.dtype
    b, nq, c = q.shape
    head_dim = c // heads
    scale = 1.0 / (head_dim**0.5)

    if use_flash and pww_mask is None and not capture_perhead:
        if not capture and k.shape[1] == nq:
            out = flash_attention(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale, bwd_config)
            return merge_heads(out).to(dtype), None
        if capture and k.shape[1] != nq:
            out, pooled = cross_attention_with_map(
                split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale
            )
            return merge_heads(out).to(dtype), _whole_mean(pooled, heads, tp)

    qh = split_heads(q, heads)
    kh = split_heads(k, heads)
    vh = split_heads(v, heads)

    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale

    if pww_mask is not None and pww_gate is not None:
        gate = torch.as_tensor(pww_gate, dtype=torch.float32, device=scores.device)
        mask = pww_mask.float().reshape(-1, 1, 1, nq, k.shape[1])  # [S, 1, 1, Nq, Nk]
        per_sample = scores.reshape(mask.shape[0], -1, *scores.shape[1:])  # [S, B/S, H, Nq, Nk]
        if tp is None:
            top = per_sample.amax(dim=(1, 2, 3, 4), keepdim=True)
        else:
            top = tensor_amax(per_sample, (1, 2, 3, 4), tp)
        scores = (per_sample + mask * (0.4 * top * gate)).reshape(scores.shape)

    probs = torch.softmax(scores, dim=-1)
    if capture_perhead:
        pooled = probs if tp is None else gather_heads(probs, heads * tp.size, tp)  # [B, H, Nq, Nk] fp32
    elif capture:
        pooled = _whole_mean(probs.mean(dim=1), heads, tp)  # [B, Nq, Nk] fp32
    else:
        pooled = None

    out = torch.matmul(probs.to(dtype), vh)
    return merge_heads(out), pooled


def _whole_mean(local_mean: torch.Tensor, heads: int, tp: Optional[TensorAxis]) -> torch.Tensor:
    """The mean over every rank's heads from this rank's mean over its
    ``heads``: the group's sum of head sums, g(mean x heads), over all
    heads; not a mean of the ranks' means, which holds for equal splits
    only."""
    if tp is None:
        return local_mean
    return reduce_from_tensor(local_mean * heads, tp) / (heads * tp.size)
