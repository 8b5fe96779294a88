"""Hand-written Hopper attention kernels and their plain PyTorch versions.

Three kernels, counterparts of the three Pallas kernels of the JAX package's
``ops/flash_attention.py``; sources in ``csrc/``, built by ``ops/build.py``:

* K1 ``flash_self_fwd`` (csrc/flash_self_fwd.cu) replaces
  ``_self_fwd`` / ``_self_fwd_kernel``: non-causal softmax(q k^T scale) v
  over [B*H, N, D], float32 scores, output in the input dtype, plus the
  float32 log-sum-exp per row for the backward. On the TPU the whole K/V of
  one (b, h) sat in VMEM for a single softmax pass; at N = 4096, D = 40 one K
  alone is 320 KB, more than a block's 227 KB of shared memory, so the kernel
  tiles the keys with an online softmax. Bound on the H100: at head_dim 40
  the N^2 exponentials of the special-function units (about 3.9e12/s) weigh
  more than the 4*N^2*D tensor-core operations per (b, h). Both products run
  on `wgmma` with S, P and O in registers, K/V tiles arrive by TMA into a
  ring of shared-memory stages, and each warpgroup runs the softmax of one
  key tile while the P V product of the previous one is in flight. Its tile
  shapes are template parameters (``K1_TILE_CONFIGS``); the main path runs
  ``K1_MAIN_CONFIG``, the microbench all of them (``flash_self_fwd_tiles``).
* K2 ``flash_self_bwd`` (csrc/flash_self_bwd.cu) replaces ``_self_bwd`` /
  ``_self_bwd_kernel`` (custom VJP ``_flash_bh_bwd``). The TPU kernel
  carried dK/dV in fp32 across sequential q-block grid steps; CUDA blocks
  run in no order, so it is three passes: delta = rowsum(dO*O), a key-tile
  parallel pass that owns dK/dV and loops over every query tile, and a
  query-tile parallel pass for dQ, both recomputing P from the saved
  log-sum-exp. No atomics, so results do not change from run to run. Bound:
  10*N^2*D operations per (b, h) on the tensor cores.
* K3 ``cross_attention_map_fwd`` (csrc/cross_attention_map.cu) replaces
  ``_cross_attention_fwd_impl`` / ``_cross_fwd_kernel``: cross-attention
  over the 77 text keys (masked at the ragged edge, not padded to 128) that
  also returns the head-mean probability map [B, Nq, K] in fp32. One block
  owns a tile of queries of one batch row and loops over the heads, so the
  map accumulates in shared memory and is written once, with no cross-block
  sum: the TPU's innermost head grid axis. Bound: under a microsecond of
  work at the main path's shapes, so at best launch latency bounds it; this
  first version is bound by the serial per-key warp sums of its one warp per
  query row. Its backward is PyTorch ops, as ``_cross_with_map_bwd`` is
  plain jnp in the JAX package.

Every wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises. The kernels take bfloat16
(the model dtype on the card); a float32 model on CUDA needs
``use_flash_attention=False``. ``LAUNCHES`` counts kernel launches per
wrapper.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# kernel launches per wrapper: K1-K3 here, the microbench variants V1 and W1
# in ``ops/attention_variants.py``
LAUNCHES = {
    "flash_self_fwd": 0, "flash_self_bwd": 0, "cross_attention_map_fwd": 0,
    "flash_self_fwd_v1": 0, "flash_self_bwd_w1": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cuda_inputs(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_head_dim(name: str, d: int) -> None:
    # the kernels are built for the presets' head dims: 40 (SD1.5), 64 (SD2.1)
    if d not in (40, 64):
        raise ValueError(f"{name}: head_dim must be 40 or 64, got {d}")


# ---------------------------------------------------------------------------
# K1 / K2: self-attention
# ---------------------------------------------------------------------------


def flash_self_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K1 (and, through autograd, of K2) over [BH, N, D]:
    float32 scores, softmax and product; output in the input dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_self_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain version of K1 with its second output: (out in the input dtype,
    natural-log logsumexp of the scaled float32 scores [BH, N], float32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float()).to(q.dtype)
    return out, lse


# K1's tile configurations, (queries, keys, stages) per block, in the order
# of csrc/flash_self_fwd.cu's configuration index; the C entry point of the
# main path runs K1_MAIN_CONFIG, the one measured fastest on the H100.
K1_TILE_CONFIGS = ((128, 128, 3), (128, 64, 3), (64, 128, 2))
K1_MAIN_CONFIG = 0


def _launch_k1(q, k, v, scale: float, config: Optional[int]):
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("flash_self_fwd", torch.bfloat16, q, k, v)
    if not (q.dim() == 3 and q.shape == k.shape == v.shape):
        raise ValueError(f"flash_self_fwd: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    bh, n, d = q.shape
    _check_head_dim("flash_self_fwd", d)
    if config is not None and (config not in range(len(K1_TILE_CONFIGS)) or (d != 40 and config != K1_MAIN_CONFIG)):
        raise ValueError(f"flash_self_fwd: no tile configuration {config} at head_dim {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_self_fwd: TMA needs 16-byte aligned q, k and v")
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, d, float(scale))
    if config is None:
        err = lib.ga_flash_self_fwd(*args, _stream(q))
    else:
        err = lib.ga_flash_self_fwd_config(*args, config, _stream(q))
    _check("flash_self_fwd", err)
    LAUNCHES["flash_self_fwd"] += 1
    return o, lse


def flash_self_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Launch K1 on [BH, N, D] bf16: returns (out bf16, lse f32 [BH, N])."""
    return _launch_k1(q, k, v, scale, None)


def flash_self_fwd_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, config: int):
    """K1 with the tile configuration ``K1_TILE_CONFIGS[config]`` (any of
    them at head_dim 40, only ``K1_MAIN_CONFIG`` at 64): the microbench's
    sweep. Same contract as ``flash_self_fwd``."""
    return _launch_k1(q, k, v, scale, config)


def flash_self_bwd(q, k, v, o, do, lse, scale: float):
    """Launch K2: returns (dq, dk, dv) in bf16."""
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("flash_self_bwd", torch.bfloat16, q, k, v, o, do)
    _check_cuda_inputs("flash_self_bwd", torch.float32, lse)
    bh, n, d = q.shape
    if not (q.shape == k.shape == v.shape == o.shape == do.shape and lse.shape == (bh, n)):
        raise ValueError("flash_self_bwd: mismatched shapes")
    _check_head_dim("flash_self_bwd", d)
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    err = lib.ga_flash_self_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, n, d, float(scale), _stream(q),
    )
    _check("flash_self_bwd", err)
    LAUNCHES["flash_self_bwd"] += 1
    return dq, dk, dv


class _FlashSelf(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_self_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_self_bwd(q, k, v, o, do.contiguous(), lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Self-attention over [B, H, N, D] without materializing the scores.

    Differentiable: K1 forward, K2 backward on CUDA bf16 tensors; the plain
    version (autograd through float32 math) for CPU tensors."""
    b, h, n, d = q.shape
    if scale is None:
        scale = 1.0 / (d**0.5)
    qf = q.reshape(b * h, n, d).contiguous()
    kf = k.reshape(b * h, n, d).contiguous()
    vf = v.reshape(b * h, n, d).contiguous()
    if q.device.type == "cpu":
        out = flash_self_plain(qf, kf, vf, float(scale))
    else:
        out = _FlashSelf.apply(qf, kf, vf, float(scale))
    return out.reshape(b, h, n, d)


# ---------------------------------------------------------------------------
# K3: cross-attention with the head-mean map
# ---------------------------------------------------------------------------


def cross_attention_map_plain(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: q [B,H,Nq,D], k/v [B,H,K,D] -> (out in q.dtype,
    head-mean probability map [B,Nq,K] f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float()).to(q.dtype)
    return out, p.mean(dim=1)


def cross_attention_map_fwd(q, k, v, scale: float):
    """Launch K3 on bf16 [B,H,Nq,D] / [B,H,K,D]: returns (out, map f32)."""
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("cross_attention_map_fwd", torch.bfloat16, q, k, v)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"cross_attention_map_fwd: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if d % 8 or d > 256 or not 1 <= nk <= 128:
        raise ValueError(f"cross_attention_map_fwd: needs head_dim % 8 == 0, <= 256 and 1 <= keys <= 128, got {d}, {nk}")
    o = torch.empty_like(q)
    pmap = torch.empty((b, nq, nk), dtype=torch.float32, device=q.device)
    lib = load_library()
    err = lib.ga_cross_attention_map_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), pmap.data_ptr(),
        b, h, nq, nk, d, float(scale), _stream(q),
    )
    _check("cross_attention_map_fwd", err)
    LAUNCHES["cross_attention_map_fwd"] += 1
    return o, pmap


def cross_attention_map_bwd(q, k, v, do, dmap, scale: float):
    """Recomputing backward in PyTorch ops (the JAX package's
    ``_cross_with_map_bwd``): recompute P, add dmap/H into dP, mask-free
    since the keys are not padded."""
    h = q.shape[1]
    qf, kf, vf, do32 = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    # map = mean_h p, so dL/dp gains dmap / H
    dp = torch.matmul(do32, vf.transpose(-1, -2)) + (dmap.float() / h)[:, None]
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do32).to(v.dtype)
    return dq, dk, dv


class _CrossWithMap(torch.autograd.Function):
    """K3 forward, PyTorch-ops backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, pmap = cross_attention_map_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return o, pmap

    @staticmethod
    def backward(ctx, do, dmap):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = cross_attention_map_bwd(q, k, v, do, dmap, ctx.scale)
        return dq, dk, dv, None


def cross_attention_with_map(q, k, v, scale: Optional[float] = None):
    """Fused cross-attention emitting the head-averaged probability map.

    q: [B, H, Nq, D]; k, v: [B, H, K, D]. Returns (out [B, H, Nq, D],
    map [B, Nq, K] fp32), differentiable in q, k and v (map included)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.device.type == "cpu":
        return cross_attention_map_plain(q, k, v, float(scale))
    return _CrossWithMap.apply(q, k, v, float(scale))
