"""The microbench variants of the self-attention kernels, V1 and W1.

Counterparts of the two Pallas kernels of the JAX package's
``scripts/perf_attn_kernel.py``, which asked whether another formulation of
K1's or K2's function is faster; sources in ``csrc/``, built by
``ops/build.py``, timed by ``perf_attn_kernel.py``. Neither is on the
generation path.

* V1 ``flash_self_fwd_v1`` (csrc/flash_self_fwd_v1.cu) replaces ``fwd_v1``
  / ``_fwd_kernel_v1``: s = (q k^T) * scale in fp32, P~ = exp(s - max), and
  o = (P~ v) / (P~ 1), numerator and denominator from one product with a
  ones column put in the zero padding of D = 40 (48 wide). ``bf16_p``
  rounds P~ to bf16 before the product; without it P~ goes through the
  product as a bf16 hi + lo pair (two products), about 2^-18 relative.
* W1 ``flash_self_bwd_w1`` (csrc/flash_self_bwd_w1.cu) replaces ``bwd_w1``
  / ``_bwd_kernel_w1``: the attention gradient from (q, k, v, do) alone,
  with no saved output or logsumexp; delta = rowsum(dP * P); P and dS
  rounded to bf16 for the products; dq in bf16, dk and dv in fp32. One
  query-tile launch that adds dK/dV into the fp32 outputs with atomics, so
  the summation order, and the last bits of dk and dv, change from run to
  run.

Both take bf16 [BH, N, 40] only: at head dim 64 V1 has no pad column for
its ones. Like every wrapper of the package, they run their plain version
for CPU tensors and, for CUDA tensors, launch the kernel or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, _check, _check_cuda_inputs, _stream

HEAD_DIM = 40


def _check_shapes(name: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}: expected equal [BH, N, D] shapes, got {[tuple(t.shape) for t in tensors]}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM}, got {q.shape[-1]}")


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


def flash_self_fwd_v1(q, k, v, scale: float, bf16_p: bool = False) -> torch.Tensor:
    """V1 on [BH, N, 40]: the kernel for bf16 CUDA tensors, the plain
    version for CPU tensors."""
    _check_shapes("flash_self_fwd_v1", q, k, v)
    if q.device.type == "cpu":
        return flash_self_fwd_v1_plain(q, k, v, scale, bf16_p)
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("flash_self_fwd_v1", torch.bfloat16, q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    err = load_library().ga_flash_self_fwd_v1(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, d, float(scale), int(bool(bf16_p)), _stream(q),
    )
    _check("flash_self_fwd_v1", err)
    LAUNCHES["flash_self_fwd_v1"] += 1
    return o


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


def flash_self_bwd_w1(q, k, v, do, scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W1 on [BH, N, 40]: (dq bf16, dk fp32, dv fp32); the kernel for bf16
    CUDA tensors, the plain version for CPU tensors."""
    _check_shapes("flash_self_bwd_w1", q, k, v, do)
    if q.device.type == "cpu":
        return flash_self_bwd_w1_plain(q, k, v, do, scale)
    from guided_attention_tpu_torch.ops.build import load_library

    _check_cuda_inputs("flash_self_bwd_w1", torch.bfloat16, q, k, v, do)
    bh, n, d = q.shape
    dq = torch.empty_like(q)
    # the kernel adds every query tile's share into dk and dv
    dk = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    err = load_library().ga_flash_self_bwd_w1(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, n, d, float(scale), _stream(q),
    )
    _check("flash_self_bwd_w1", err)
    LAUNCHES["flash_self_bwd_w1"] += 1
    return dq, dk, dv
