"""The benchmark's own count of the work, and the H100's published peaks.

A frozen copy of the UNet FLOP arithmetic (every matmul and convolution
multiply-accumulate counts 2 FLOPs; norms, activations and softmax are
left out, under 1% at SD scale), walking the UNet's block structure from
a configuration file's sizes, and the attention layers' work alone: their
projections and their score and value products, with the bytes such a
layer must move at the least (each input, weight and output once, in
bf16). Both count the work of the computation, whichever kernel runs it.
A guidance eval's backward is counted as what it computes: every weight is
frozen and the gradient is the latent's alone, so each product on the
path to the loss costs its data gradient only (about 2.09x the truncated
forward in all, not the 3x of a training step).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes
CTX_LEN = 77


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout * h * w


def _dense(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def _attn_parts(q_len: int, kv_len: int, inner: int, query_dim: int, ctx_dim: int) -> Tuple[float, ...]:
    """FLOPs of an attention layer's to_q, to_k and to_v together, score
    and value products (Q K^T and P V), and to_out, on one row."""
    return (_dense(q_len, query_dim, inner), 2 * _dense(kv_len, ctx_dim, inner),
            4.0 * q_len * kv_len * inner, _dense(q_len, inner, query_dim))


def attention_work(q_len: int, kv_len: int, inner: int, query_dim: int, ctx_dim: int,
                   self_attention: bool) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one attention layer's forward on one row:
    to_q, to_k, to_v, Q K^T, P V, to_out; bytes of its input, context (a
    self-attention's is its input), four weights and the output bias,
    and its output."""
    f = sum(_attn_parts(q_len, kv_len, inner, query_dim, ctx_dim))
    elems = q_len * query_dim * 2 + (0 if self_attention else kv_len * ctx_dim)
    elems += inner * query_dim * 2 + inner * ctx_dim * 2 + query_dim
    return f, elems * BF16


def _layers(u: Dict, truncate_at_res: Optional[int] = None) -> Iterator[Tuple[str, int, int]]:
    """(place, resolution, channels) of every attention layer in forward
    order, stopping after the last one at ``truncate_at_res``."""
    chs, res = u["block_out_channels"], u["sample_size"]
    order = []
    for i, ch in enumerate(chs):
        if u["attn_down"][i]:
            order += [("down", res >> i, ch, u["num_heads"][i])] * u["layers_per_block"]
    n = len(chs)
    order.append(("mid", res >> (n - 1), chs[-1], u["num_heads"][-1]))
    for i, (ch, has) in enumerate(zip(reversed(chs), reversed(u["attn_down"]))):
        if has:
            order += [("up", res >> (n - 1 - i), ch, list(reversed(u["num_heads"]))[i])] * (u["layers_per_block"] + 1)
    if truncate_at_res is not None:
        last = max(k for k, o in enumerate(order) if o[1] == truncate_at_res)
        order = order[:last + 1]
    return iter(order)


def attention_forward(u: Dict, truncate_at_res: Optional[int] = None) -> Tuple[float, float]:
    """(FLOPs, least bytes) of every attention layer (attn1 and attn2) of one
    UNet forward of one row."""
    f = b = 0.0
    for _place, res, ch, heads in _layers(u, truncate_at_res):
        n = res * res
        for kv, ctx_dim, is_self in ((n, ch, True), (CTX_LEN, u["cross_attention_dim"], False)):
            df, db = attention_work(n, kv, ch, ch, ctx_dim, is_self)
            f, b = f + df, b + db
    return f, b


def attention_backward(q_len: int, kv_len: int, inner: int, query_dim: int, ctx_dim: int,
                       self_attention: bool, scores_only: bool = False) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one attention layer's part of the guidance
    eval's backward on one row. Every weight is frozen and the gradient is
    taken of the latent alone, so each product's backward is its data
    gradient: one product as large as the forward's for to_q, to_k, to_v
    and to_out, and for the score and value products dP = dO V^T and
    dQ = dS K, with dK = dS^T Q and dV = P^T dO only where K and V come
    from the latent (self-attention). A cross-attention's K and V come from
    the text and get no gradient. ``scores_only``: the layer the eval stops
    in, whose gradient enters at its scores: dQ = dS K and to_q's alone.
    Bytes: what the forward read, the output's gradient read and the
    input's gradient written (with ``scores_only``: the input, the context,
    to_q's and to_k's weights, and the input's gradient)."""
    q, kv, core, out = _attn_parts(q_len, kv_len, inner, query_dim, ctx_dim)
    if scores_only:
        elems = q_len * query_dim * 2 + kv_len * ctx_dim + inner * query_dim + inner * ctx_dim
        return q + core / 2, elems * BF16
    f = q + out + (kv + 2 * core if self_attention else core)
    _f, b = attention_work(q_len, kv_len, inner, query_dim, ctx_dim, self_attention)
    return f, b + q_len * query_dim * BF16


def _attention_layers(u: Dict, truncate_at_res: int) -> Iterator[Tuple[int, int, int, int, bool, bool]]:
    """(query length, channels, kv length, context width, self-attention,
    scores only) of attn1 and attn2 of every layer of the eval's forward."""
    layers = list(_layers(u, truncate_at_res))
    for k, (_place, res, ch, _heads) in enumerate(layers):
        n = res * res
        yield n, ch, n, ch, True, False
        yield n, ch, CTX_LEN, u["cross_attention_dim"], False, k == len(layers) - 1


def attention_eval(u: Dict, capture_res: int = 16) -> Tuple[float, float]:
    """(FLOPs, least bytes) of the attention layers of one guidance eval of
    one row: the truncated forward and its backward (``attention_backward``)."""
    f, b = attention_forward(u, capture_res)
    for n, ch, kv, ctx_dim, is_self, last in _attention_layers(u, capture_res):
        df, db = attention_backward(n, kv, ch, ch, ctx_dim, is_self, last)
        f, b = f + df, b + db
    return f, b


def _resnet(res: int, cin: int, cout: int, temb_dim: int) -> Iterator[Tuple[float, float]]:
    """(forward, eval backward) FLOPs of a ResNet block's products: the
    convolutions' data gradients, none for the time embedding's projection."""
    for conv in (_conv(res, res, cin, cout, 3), _conv(res, res, cout, cout, 3)):
        yield conv, conv
    yield _dense(1, temb_dim, cout), 0.0
    if cin != cout:
        yield _conv(res, res, cin, cout, 1), _conv(res, res, cin, cout, 1)


def _transformer2d(res: int, ch: int, ctx_dim: int, last: bool = False) -> Iterator[Tuple[float, float]]:
    """(forward, eval backward) FLOPs of a transformer block's products:
    proj_in, attn1, attn2, the GEGLU feed-forward, proj_out. ``last``: the
    block the eval stops in, of which nothing after attn2's scores reaches
    the loss."""
    n = res * res
    proj = _dense(n, ch, ch)
    ff = _dense(n, ch, ch * 8) + _dense(n, ch * 4, ch)
    yield proj, proj
    yield attention_work(n, n, ch, ch, ch, True)[0], attention_backward(n, n, ch, ch, ch, True)[0]
    yield (attention_work(n, CTX_LEN, ch, ch, ctx_dim, False)[0],
           attention_backward(n, CTX_LEN, ch, ch, ctx_dim, False, last)[0])
    yield ff, 0.0 if last else ff
    yield proj, 0.0 if last else proj


def _unet(u: Dict, truncate_at_res: Optional[int] = None) -> Iterator[Tuple[float, float]]:
    """(forward, eval backward) FLOPs of every product of one UNet forward
    of one row, or of the guidance eval's forward truncated after the last
    attention layer at ``truncate_at_res``. The backward is the eval's:
    the gradient of the latent alone."""
    chs = u["block_out_channels"]
    n = len(chs)
    temb = chs[0] * 4
    res = u["sample_size"]
    ctx_dim = u["cross_attention_dim"]
    yield _dense(1, chs[0], temb) + _dense(1, temb, temb), 0.0
    yield _conv(res, res, u["in_channels"], chs[0]), _conv(res, res, u["in_channels"], chs[0])
    skips, cur = [chs[0]], chs[0]
    for i, out in enumerate(chs):
        for _ in range(u["layers_per_block"]):
            yield from _resnet(res, cur, out, temb)
            cur = out
            if u["attn_down"][i]:
                yield from _transformer2d(res, cur, ctx_dim)
            skips.append(cur)
        if i != n - 1:
            yield _conv(res // 2, res // 2, out, out), _conv(res // 2, res // 2, out, out)
            res //= 2
            skips.append(out)
    yield from _resnet(res, cur, cur, temb)
    yield from _transformer2d(res, cur, ctx_dim)
    yield from _resnet(res, cur, cur, temb)
    for i, (out, has) in enumerate(zip(reversed(chs), reversed(u["attn_down"]))):
        stop = has and res == truncate_at_res
        for j in range(u["layers_per_block"] + 1):
            yield from _resnet(res, cur + skips.pop(), out, temb)
            cur = out
            if has:
                yield from _transformer2d(res, cur, ctx_dim, last=stop and j == u["layers_per_block"])
        if stop:
            return
        if i != n - 1:
            res *= 2
            yield _conv(res, res, out, out), _conv(res, res, out, out)
    yield _conv(res, res, cur, u["out_channels"]), 0.0


def unet_forward_flops(u: Dict, truncate_at_res: Optional[int] = None) -> float:
    """FLOPs of one UNet forward of one row, or of the guidance eval's
    forward truncated after the last attention layer at ``truncate_at_res``."""
    return sum(f for f, _b in _unet(u, truncate_at_res))


def eval_flops(u: Dict, capture_res: int = 16) -> float:
    """FLOPs of one guidance eval of one row: the truncated forward and the
    latent's gradient through it."""
    return sum(f + b for f, b in _unet(u, capture_res))


def image_flops(u: Dict, n_evals: np.ndarray, recursions: np.ndarray, capture_res: int = 16) -> float:
    """UNet FLOPs of one guided image from its own counters: per step, a
    CFG forward of two rows per executed recursion, and each guidance eval."""
    fwd, ev = unet_forward_flops(u), eval_flops(u, capture_res)
    return float(np.sum(np.asarray(n_evals)) * ev + np.sum(np.maximum(np.asarray(recursions), 1)) * 2 * fwd)


def image_attention(u: Dict, n_evals: np.ndarray, recursions: np.ndarray, capture_res: int = 16) -> Tuple[float, float]:
    """(FLOPs, least bytes) of one guided image's attention layers."""
    ff, fb = attention_forward(u)
    ef, eb = attention_eval(u, capture_res)
    cfg_rows = float(np.sum(np.maximum(np.asarray(recursions), 1)) * 2)
    evals = float(np.sum(np.asarray(n_evals)))
    return cfg_rows * ff + evals * ef, cfg_rows * fb + evals * eb


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
