"""The microbench variants of the self-attention kernels, V1 and W1.

Counterparts of the two Pallas kernels of the JAX package's
``scripts/perf_attn_kernel.py``, which asked whether another formulation of
K1's or K2's function is faster; sources in ``csrc/``, built by
``ops/build.py``, timed by ``perf_attn_kernel.py``. Neither is on the
generation path. Both are built for Hopper on ``csrc/hopper.cuh``, as K1
and K2 are: every product on `wgmma`, streamed tiles by TMA into mbarrier
rings.

* V1 ``flash_self_fwd_v1`` (csrc/flash_self_fwd_v1.cu) replaces ``fwd_v1``
  / ``_fwd_kernel_v1``: s = (q k^T) * scale in fp32, P~ = exp(s - max), and
  o = (P~ v) / (P~ 1), numerator and denominator from the same P~ operand
  on the tensor cores: the denominator is a product with an all-ones tile
  beside P~ V. ``bf16_p`` rounds P~ to bf16 before the products; without it
  P~ goes through them as a bf16 hi + lo pair (twice the products), about
  2^-18 relative. K1's design otherwise: S, P~ and O in registers, an
  online max, K/V by TMA into a ring.
* W1 ``flash_self_bwd_w1`` (csrc/flash_self_bwd_w1.cu) replaces ``bwd_w1``
  / ``_bwd_kernel_w1``: the attention gradient from (q, k, v, do) alone,
  with no saved output or logsumexp; delta = rowsum(dP * P); P and dS
  rounded to bf16 for the products; dq in bf16, dk and dv in fp32. Two
  launches that each own their outputs: statistics and dQ over query
  tiles, then dK and dV over key tiles (K2's passes), so there are no
  atomics and the gradients are the same bits from run to run.

Both take bf16 [BH, N, D] with D = 40 (SD1.5) or 64 (SD2.1). Their tile
shapes are template parameters: ``V1_CONFIGS`` and ``W1_CONFIGS`` mirror
the sources' tables, the entry points run ``V1_MAIN_CONFIG[bf16_p]`` and
``W1_MAIN_CONFIG``, and ``flash_self_fwd_v1_config`` /
``flash_self_bwd_w1_config`` reach any of them (the microbench's sweep).
Like every wrapper of the package, they run their plain version for CPU
tensors and, for CUDA tensors, launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, _check, _check_cuda_inputs, _stream

# the head dims the kernels are built for: 40 (SD1.5), 64 (SD2.1)
HEAD_DIMS = (40, 64)

# V1's tile configurations, (queries, keys, stages) per block, in the order
# of csrc/flash_self_fwd_v1.cu's configuration index; the entry point runs
# V1_MAIN_CONFIG[bf16_p]: 64-key tiles for the hi + lo pair (128-key tiles
# spill there), 128-key tiles for bf16 P~.
V1_CONFIGS = ((128, 128, 3), (128, 64, 3), (64, 128, 2))
V1_MAIN_CONFIG = (1, 0)

# W1's tile configurations, in the order of csrc/flash_self_bwd_w1.cu's
# configuration index: ((keys per block, queries per tile, stages) of the
# dK/dV pass, (queries per block, keys per tile, stages) of the
# statistics-and-dQ pass).
W1_CONFIGS = (((128, 64, 4), (128, 64, 4)), ((128, 64, 2), (128, 64, 2)), ((64, 64, 4), (64, 64, 4)))
W1_MAIN_CONFIG = 0


def _check_shapes(name: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: expected equal [BH, N, D] shapes, got {[tuple(t.shape) for t in tensors]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, got {q.shape[-1]}")


def _check_config(name: str, config: Optional[int], count: int) -> None:
    if config is not None and config not in range(count):
        raise ValueError(f"{name}: no tile configuration {config}")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: TMA needs 16-byte aligned inputs")


# ---------------------------------------------------------------------------
# V1: ones-column forward
# ---------------------------------------------------------------------------


def flash_self_fwd_v1_plain(q, k, v, scale: float, bf16_p: bool = False) -> torch.Tensor:
    """Plain version of V1 over [BH, N, D]: fp32 scores times ``scale``,
    P~ = exp(s - rowmax) (rounded to bf16 if ``bf16_p``), and
    (P~ v) / rowsum(P~) in fp32; output in the input dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if bf16_p:
        p = p.to(torch.bfloat16).float()
    return (torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _v1(q, k, v, scale: float, bf16_p: bool, config: Optional[int]) -> torch.Tensor:
    name = "flash_self_fwd_v1"
    _check_shapes(name, q, k, v)
    _check_config(name, config, len(V1_CONFIGS))
    if q.device.type == "cpu":
        return flash_self_fwd_v1_plain(q, k, v, scale, bf16_p)
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs(name, torch.bfloat16, q, k, v)
    _check_aligned(name, q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    lib = load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, d, float(scale), int(bool(bf16_p)))
    if config is None:
        err = lib.ga_flash_self_fwd_v1(*args, _stream(q))
    else:
        err = lib.ga_flash_self_fwd_v1_config(*args, config, _stream(q))
    _check(name, err)
    LAUNCHES[name] += 1
    return o


def flash_self_fwd_v1(q, k, v, scale: float, bf16_p: bool = False) -> torch.Tensor:
    """V1 on [BH, N, 40|64]: the kernel (``V1_MAIN_CONFIG[bf16_p]``) for bf16
    CUDA tensors, the plain version for CPU tensors."""
    return _v1(q, k, v, scale, bf16_p, None)


def flash_self_fwd_v1_config(q, k, v, scale: float, bf16_p: bool, config: int) -> torch.Tensor:
    """V1 with the tile configuration ``V1_CONFIGS[config]``: the
    microbench's sweep. Same contract as ``flash_self_fwd_v1``."""
    return _v1(q, k, v, scale, bf16_p, config)


# ---------------------------------------------------------------------------
# W1: backward without saved statistics
# ---------------------------------------------------------------------------


def flash_self_bwd_w1_plain(q, k, v, do, scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of W1 over [BH, N, D]: returns (dq in q's dtype, dk
    fp32, dv fp32), P and dS rounded to bf16 for the three products."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(pb.transpose(-1, -2), dof)
    return dq, dk, dv


def _w1(q, k, v, do, scale: float, config: Optional[int]):
    name = "flash_self_bwd_w1"
    _check_shapes(name, q, k, v, do)
    _check_config(name, config, len(W1_CONFIGS))
    if q.device.type == "cpu":
        return flash_self_bwd_w1_plain(q, k, v, do, scale)
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs(name, torch.bfloat16, q, k, v, do)
    _check_aligned(name, q, k, v, do)
    bh, n, d = q.shape
    # the first pass's row statistics for the second: -lse2 and delta * scale
    stats = torch.empty((2, bh, n), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, n, d, float(scale))
    if config is None:
        err = lib.ga_flash_self_bwd_w1(*args, _stream(q))
    else:
        err = lib.ga_flash_self_bwd_w1_config(*args, config, _stream(q))
    _check(name, err)
    LAUNCHES[name] += 1
    return dq, dk, dv


def flash_self_bwd_w1(q, k, v, do, scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W1 on [BH, N, 40|64]: (dq bf16, dk fp32, dv fp32); the kernel
    (``W1_MAIN_CONFIG``) for bf16 CUDA tensors, the plain version for CPU
    tensors."""
    return _w1(q, k, v, do, scale, None)


def flash_self_bwd_w1_config(q, k, v, do, scale: float, config: int):
    """W1 with the tile configuration ``W1_CONFIGS[config]``: the
    microbench's sweep. Same contract as ``flash_self_bwd_w1``."""
    return _w1(q, k, v, do, scale, config)
