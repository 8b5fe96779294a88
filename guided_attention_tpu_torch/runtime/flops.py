"""Analytic FLOP counts of the UNet, the H100's peaks, and roofline bounds.

Counterpart of the JAX package's ``runtime/flops.py``: counts matmul and
convolution multiply-accumulates (2 FLOPs each) by walking the same block
structure as ``models/unet.py`` (norms, activations and softmax are
omitted: under 1% of the total at SD scale). The numerator of the model-FLOP
share (MFU) of a generation, against the H100's bf16 tensor-core peak.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from guided_attention_tpu_torch.models.unet import UNetConfig

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
H100_BF16_PEAK_FLOPS = 989e12  # bf16 tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3
# exp2 on the special-function units: 16 results per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput table, compute capability 9.0)
# x 132 SMs x ~1.83 GHz = 3.87e12/s, rounded as FlashAttention-3 does
H100_EXP2_PER_S = 3.9e12


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout * h * w


def _dense(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def _attention(q_len: int, kv_len: int, inner: int, query_dim: int, ctx_dim: int) -> float:
    f = _dense(q_len, query_dim, inner)  # to_q
    f += 2 * _dense(kv_len, ctx_dim, inner)  # to_k, to_v
    f += 2.0 * q_len * kv_len * inner  # q @ k^T
    f += 2.0 * q_len * kv_len * inner  # probs @ v
    f += _dense(q_len, inner, query_dim)  # to_out
    return f


def _transformer2d(res: int, ch: int, heads: int, dim_head: int, ctx_len: int, ctx_dim: int) -> float:
    n = res * res
    inner = heads * dim_head
    f = _dense(n, ch, inner) + _dense(n, inner, ch)  # proj_in / proj_out (1x1 or linear)
    f += _attention(n, n, inner, inner, inner)  # attn1 (self)
    f += _attention(n, ctx_len, inner, inner, ctx_dim)  # attn2 (cross)
    # GEGLU feed-forward: dim -> 8*dim proj, (4*dim) -> dim out
    f += _dense(n, inner, inner * 8) + _dense(n, inner * 4, inner)
    return f


def _resnet(res: int, cin: int, cout: int, temb_dim: int) -> float:
    f = _conv(res, res, cin, cout, 3) + _conv(res, res, cout, cout, 3)
    f += _dense(1, temb_dim, cout)
    if cin != cout:
        f += _conv(res, res, cin, cout, 1)
    return f


def unet_forward_flops(cfg: UNetConfig, batch: int = 1, ctx_len: int = 77,
                       truncate_at_res: Optional[int] = None) -> float:
    """Analytic FLOPs of ONE UNet forward at the config's sample_size.

    Follows ``UNet2DCondition.forward``'s channel and resolution bookkeeping,
    skip-concat channel growth in the up path included. ``truncate_at_res``
    stops after the last attention up-block at that resolution, where the
    guidance eval's truncated forward stops (``unet_eval_flops``).
    """
    chs = cfg.block_out_channels
    n_blocks = len(chs)
    temb_dim = chs[0] * 4
    res = cfg.sample_size
    f = 0.0

    f += _dense(1, chs[0], temb_dim) + _dense(1, temb_dim, temb_dim)  # time embedding MLP
    f += _conv(res, res, cfg.in_channels, chs[0], 3)  # conv_in

    skip_chs = [chs[0]]  # channels of the skip connections, in push order
    cur = chs[0]
    # --- down ---
    for i, out_ch in enumerate(chs):
        for _ in range(cfg.layers_per_block):
            f += _resnet(res, cur, out_ch, temb_dim)
            cur = out_ch
            if cfg.attn_down[i]:
                f += _transformer2d(
                    res, cur, cfg.num_heads[i], cur // cfg.num_heads[i],
                    ctx_len, cfg.cross_attention_dim,
                )
            skip_chs.append(cur)
        if i != n_blocks - 1:
            f += _conv(res // 2, res // 2, out_ch, out_ch, 3)  # downsample
            res //= 2
            skip_chs.append(out_ch)

    # --- mid ---
    mid = chs[-1]
    f += _resnet(res, cur, mid, temb_dim)
    f += _transformer2d(res, mid, cfg.num_heads[-1], mid // cfg.num_heads[-1], ctx_len, cfg.cross_attention_dim)
    f += _resnet(res, mid, mid, temb_dim)
    cur = mid

    # --- up ---
    rev_ch = list(reversed(chs))
    rev_attn = list(reversed(cfg.attn_down))
    rev_heads = list(reversed(cfg.num_heads))
    for i in range(n_blocks):
        out_ch = rev_ch[i]
        for _ in range(cfg.layers_per_block + 1):
            skip = skip_chs.pop()
            f += _resnet(res, cur + skip, out_ch, temb_dim)
            cur = out_ch
            if rev_attn[i]:
                f += _transformer2d(
                    res, cur, rev_heads[i], cur // rev_heads[i],
                    ctx_len, cfg.cross_attention_dim,
                )
        if rev_attn[i] and res == truncate_at_res:
            return f * batch  # last captured layer reached; the rest is not run
        if i != n_blocks - 1:
            res *= 2
            f += _conv(res, res, out_ch, out_ch, 3)  # upsample conv

    f += _conv(res, res, cur, cfg.out_channels, 3)  # conv_out
    return f * batch


def unet_eval_flops(cfg: UNetConfig, capture_res: int = 16, batch: int = 1, ctx_len: int = 77) -> float:
    """FLOPs of one guidance-eval forward: the UNet truncated after the last
    up-block at ``capture_res`` (``UNet2DCondition.forward(truncate=True)``;
    the eval's loss reads only the captured cross maps)."""
    return unet_forward_flops(cfg, batch=batch, ctx_len=ctx_len, truncate_at_res=capture_res)


def generation_flops(cfg: UNetConfig, diags, num_steps: int, cfg_batch: int = 2,
                     capture_res: int = 16) -> float:
    """Total executed UNet FLOPs of one guided generation, from the run's own
    counters (``StepDiag``): ``n_evals`` guidance evals per step (cumulative
    over re-noise recursions; each a truncated forward and backward, about 3x
    the truncated forward by the usual 2x rule for the backward) plus one
    batch-``cfg_batch`` CFG forward per executed recursion. CLIP and the VAE
    are omitted (under 1% of a 50-step generation).
    """
    fwd = unet_forward_flops(cfg, batch=1)
    ev = unet_eval_flops(cfg, capture_res, batch=1)
    total = 0.0
    n_evals = np.asarray(diags.n_evals)
    recur = np.asarray(diags.recursions)
    for i in range(num_steps):
        r = max(int(recur[i]), 1)
        total += int(n_evals[i]) * 3.0 * ev + r * cfg_batch * fwd
    return total


def mfu(flops: float, seconds: float, peak: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model-FLOP share of the peak: ``flops`` done in ``seconds``."""
    return flops / seconds / peak


def bound_ms(flops: float, nbytes: float, exps: float = 0.0) -> Tuple[float, str]:
    """The least time the H100 could take for work of ``flops`` bf16
    tensor-core operations and ``exps`` exponentials that must move
    ``nbytes`` (each input read once, each output written once): the largest
    of the three times, in ms, and which of "operations", "exp" and "bytes"
    it is. Attention does one exponential per (query, key) pair, which at
    head dim 40 takes longer than its products."""
    times = {
        "operations": flops / H100_BF16_PEAK_FLOPS * 1e3,
        "exp": exps / H100_EXP2_PER_S * 1e3,
        "bytes": nbytes / H100_HBM_BYTES_PER_S * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by
