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
  ``_self_bwd_kernel`` (custom VJP ``_flash_bh_bwd``). The TPU kernel held
  one (b, h)'s K and V in VMEM and carried dK/dV in fp32 across sequential
  q-block grid steps; CUDA blocks run in no order and hold a few tiles, so
  it is two passes that each own their outputs, recomputing P from K1's
  saved log-sum-exp: a query-tile pass for dQ that also computes delta =
  rowsum(dO*O) in its prologue, then a key-tile pass for dK and dV. No
  atomics and no cross-block sum, so results are bitwise the same from run
  to run. Bound: 10*N^2*D tensor-core operations per (b, h); the two passes
  recompute S and dP, and at head_dim 40 the tiles pad to 768 operations
  per (query, key) pair. Every product runs on `wgmma` (scores from shared
  memory, gradient products with P and dS from registers) and streamed
  tiles arrive by TMA into rings of shared-memory stages. Registers bound
  the schedule: each warpgroup runs a tile's scores, exponentials and
  gradient products in order, and the two warpgroups of a block overlap
  one's exponentials with the other's products. Its tile shapes are
  template parameters (``K2_TILE_CONFIGS``); the main path runs
  ``K2_MAIN_CONFIG``, the microbench all of them (``flash_self_bwd_tiles``).
* K3 ``cross_attention_map_fwd`` (csrc/cross_attention_map.cu) replaces
  ``_cross_attention_fwd_impl`` / ``_cross_fwd_kernel``: cross-attention
  over the 77 text keys that also returns the head-mean probability map
  [B, Nq, K] in fp32. The TPU kernel summed the map over an innermost
  sequential head grid axis; here the heads are split over the blocks of a
  thread-block cluster (at most 8 blocks, so 20 heads go 3 or 2 to a
  block) and the map is summed across the cluster through distributed
  shared memory, in a fixed order, with no atomics: out and map are bitwise
  the same from run to run. Bound: under a microsecond of work at the main
  path's shapes (q [1, 8, 256, 160]), so latency bounds it: the launch, the
  loads and the chain of instructions each warp runs per head. Both
  products run on the tensor cores (``mma.sync`` m16n8k16; keys padded to
  16 and masked), four warps to each 16 query rows (splitting the keys of
  Q K^T and the softmax, the columns of P V), Q, K and V arrive as TMA
  boxes, and P is rounded to bf16 only for P V, as the TPU kernel does; the
  main shape runs 128 blocks. Its tiles are ``K3_TILE_CONFIGS``;
  ``cross_map_geometry`` gives the grid, cluster and heads per block. Its
  backward is PyTorch ops, as ``_cross_with_map_bwd`` is plain jnp in the
  JAX package.

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


# the kernels are built for the presets' head dims: 40 (SD1.5), 64 (SD2.1)
KERNEL_HEAD_DIMS = (40, 64)


def _check_head_dim(name: str, d: int) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be 40 or 64, got {d}")


# ---------------------------------------------------------------------------
# K1 / K2: self-attention
# ---------------------------------------------------------------------------


def flash_self_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K1 over [BH, N, D]: float32 scores, softmax and
    product; output in the input dtype. Autograd through it is the CPU
    route's backward."""
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


def flash_self_bwd_plain(q, k, v, o, do, lse, scale: float):
    """Plain version of K2 with K2's contract: from the forward's output ``o``
    and natural-log logsumexp ``lse`` [BH, N], delta = rowsum(dO * O) and
    P = exp(s - lse) in float32; returns (dq, dk, dv) in the input dtype."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float()[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# K2's tile configurations, in the order of csrc/flash_self_bwd.cu's
# configuration index: ((keys per block, queries per tile, stages) of the
# dK/dV pass, (queries per block, keys per tile, stages) of the dQ pass).
# The C entry point of the main path runs K2_MAIN_CONFIG, the one measured
# fastest on the H100.
K2_TILE_CONFIGS = (((128, 64, 4), (128, 64, 4)), ((128, 64, 2), (128, 64, 2)), ((64, 64, 4), (64, 64, 4)))
K2_MAIN_CONFIG = 0


def _launch_k2(q, k, v, o, do, lse, scale: float, config: Optional[int]):
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("flash_self_bwd", torch.bfloat16, q, k, v, o, do)
    _check_cuda_inputs("flash_self_bwd", torch.float32, lse)
    if q.dim() != 3:
        raise ValueError(f"flash_self_bwd: expected [BH, N, D], got {tuple(q.shape)}")
    bh, n, d = q.shape
    if not (q.shape == k.shape == v.shape == o.shape == do.shape and lse.shape == (bh, n)):
        raise ValueError("flash_self_bwd: mismatched shapes")
    _check_head_dim("flash_self_bwd", d)
    if config is not None and (config not in range(len(K2_TILE_CONFIGS)) or (d != 40 and config != K2_MAIN_CONFIG)):
        raise ValueError(f"flash_self_bwd: no tile configuration {config} at head_dim {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_self_bwd: TMA and 16-byte row loads need 16-byte aligned q, k, v, o and do")
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, n, d, float(scale))
    if config is None:
        err = lib.ga_flash_self_bwd(*args, _stream(q))
    else:
        err = lib.ga_flash_self_bwd_config(*args, config, _stream(q))
    _check("flash_self_bwd", err)
    LAUNCHES["flash_self_bwd"] += 1
    return dq, dk, dv


def flash_self_bwd(q, k, v, o, do, lse, scale: float):
    """K2 on [BH, N, D]: (dq, dk, dv) in the input dtype from K1's output
    and logsumexp. Launches the kernel on CUDA bf16 tensors; runs
    ``flash_self_bwd_plain`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_self_bwd_plain(q, k, v, o, do, lse, scale)
    return _launch_k2(q, k, v, o, do, lse, scale, None)


def flash_self_bwd_tiles(q, k, v, o, do, lse, scale: float, config: int):
    """K2 with the tile configuration ``K2_TILE_CONFIGS[config]`` (any of
    them at head_dim 40, only ``K2_MAIN_CONFIG`` at 64): the microbench's
    sweep. Same contract as ``flash_self_bwd``."""
    if q.device.type == "cpu":
        return flash_self_bwd_plain(q, k, v, o, do, lse, scale)
    return _launch_k2(q, k, v, o, do, lse, scale, config)


class _FlashSelf(torch.autograd.Function):
    """K1 forward, K2 backward (in its main configuration, or in
    ``K2_TILE_CONFIGS[bwd_config]``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bwd_config):
        o, lse = flash_self_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.bwd_config = scale, bwd_config
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.bwd_config is None:
            dq, dk, dv = flash_self_bwd(q, k, v, o, do.contiguous(), lse, ctx.scale)
        else:
            dq, dk, dv = flash_self_bwd_tiles(q, k, v, o, do.contiguous(), lse, ctx.scale, ctx.bwd_config)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: Optional[float] = None, bwd_config: Optional[int] = None):
    """Self-attention over [B, H, N, D] without materializing the scores.

    Differentiable: K1 forward, K2 backward on CUDA bf16 tensors (K2 in
    the tile configuration ``bwd_config`` where one is given); the plain
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
        out = _FlashSelf.apply(qf, kf, vf, float(scale), bwd_config)
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


# K3's tile configurations, (query rows per block, heads per block at least),
# in the order of csrc/cross_attention_map.cu's configuration index; the
# main path runs K3_MAIN_CONFIG.
K3_TILE_CONFIGS = ((16, 1), (32, 1), (64, 1), (16, 2))
K3_MAIN_CONFIG = 0
K3_MAX_CLUSTER = 8  # the portable thread-block cluster size
K3_MAX_KEYS, K3_MAX_HEAD_DIM = 128, 256


def cross_map_geometry(b: int, h: int, nq: int, nk: int, d: int, config: int = K3_MAIN_CONFIG) -> dict:
    """K3's launch for q [b, h, nq, d] and k/v [b, h, nk, d] in tile
    configuration ``config``: a block per (head group, query tile, batch
    row), the head groups of one query tile forming one cluster.

    Returns ``grid`` (groups, query tiles, b), ``cluster`` (blocks per
    cluster = head groups), ``heads_per_block`` (the last group may hold
    fewer) and ``blocks``. Raises on shapes the kernel does not take."""
    if d % 8 or not 8 <= d <= K3_MAX_HEAD_DIM:
        raise ValueError(f"cross_attention_map_fwd: head_dim must be a multiple of 8 in [8, 256], got {d}")
    if not 1 <= nk <= K3_MAX_KEYS:
        raise ValueError(f"cross_attention_map_fwd: needs 1 <= keys <= {K3_MAX_KEYS}, got {nk}")
    if config not in range(len(K3_TILE_CONFIGS)):
        raise ValueError(f"cross_attention_map_fwd: no tile configuration {config}")
    rows, min_heads = K3_TILE_CONFIGS[config]
    heads_per_block = max(min_heads, -(-h // K3_MAX_CLUSTER))
    groups = -(-h // heads_per_block)
    grid = (groups, -(-nq // rows), b)
    return {"grid": grid, "cluster": groups, "heads_per_block": heads_per_block, "blocks": grid[0] * grid[1] * grid[2]}


def _launch_k3(q, k, v, scale: float, config: int):
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("cross_attention_map_fwd", torch.bfloat16, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"cross_attention_map_fwd: expected q [B,H,Nq,D], got {tuple(q.shape)}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"cross_attention_map_fwd: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    geo = cross_map_geometry(b, h, nq, nk, d, config)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("cross_attention_map_fwd: TMA needs 16-byte aligned q, k and v")
    o = torch.empty_like(q)
    pmap = torch.empty((b, nq, nk), dtype=torch.float32, device=q.device)
    lib = load_library()
    err = lib.ga_cross_attention_map_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), pmap.data_ptr(),
        b, h, nq, nk, d, float(scale), config, geo["heads_per_block"], _stream(q),
    )
    _check("cross_attention_map_fwd", err)
    LAUNCHES["cross_attention_map_fwd"] += 1
    return o, pmap


def cross_attention_map_fwd(q, k, v, scale: float):
    """Launch K3 on bf16 [B,H,Nq,D] / [B,H,K,D]: returns (out, map f32)."""
    return _launch_k3(q, k, v, scale, K3_MAIN_CONFIG)


def cross_attention_map_tiles(q, k, v, scale: float, config: int):
    """K3 with the tile configuration ``K3_TILE_CONFIGS[config]``: the
    microbench's sweep and the chip check's. Same contract as
    ``cross_attention_map_fwd``."""
    return _launch_k3(q, k, v, scale, config)


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
