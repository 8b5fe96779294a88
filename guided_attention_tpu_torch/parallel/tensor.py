"""Megatron-style tensor parallelism: the collectives of the mesh's tensor axis.

Counterpart of what GSPMD inserts for the JAX package's ``DEFAULT_TP_RULES``
(``parallel/mesh.py``): there the jitted program is partitioned and the
all-reduces placed by the compiler; here each rank of a tensor group runs
the UNet with its slices of the transformer projections
(``mesh.shard_unet``), and the modules call these functions where the
partial results meet:

  * ``copy_to_tensor`` (Megatron's f): identity forward, all-reduce (sum)
    backward; before each column-sharded projection, whose input every rank
    holds whole and whose gradient each rank holds a part of;
  * ``reduce_from_tensor`` (g): all-reduce (sum) forward, identity
    backward; after each row-sharded projection and each sum over local
    heads. Every rank computes the same loss from the same reduced value, so
    the gradient reaching g is already whole on every rank: its backward
    must not reduce again (``torch.distributed.nn.functional.all_reduce``
    does, and would multiply the gradient by the group's size);
  * ``tensor_amax``: the max over every rank's heads (paint-with-words'
    score max), whose backward sums the upstream gradient over the group and
    hands it to the maxima, split among ties as ``amax`` splits it;
  * ``gather_heads``: per-head maps of every rank, by an all-reduce of a
    zero-filled buffer (gloo, the backend of ranks sharing a card, reduces
    and broadcasts CUDA tensors but does not gather them).

With these the latent gradient of a guidance eval is whole and equal on
every rank of a group. ``COLLECTIVES`` counts the all-reduces and their
bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

COLLECTIVES = {"all_reduce": 0, "bytes": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """A rank's place on the tensor axis: its group (None: a group of one,
    for tests without a process group), the group's size and the rank's
    index in it, which picks its slice of each sharded projection."""

    group: Any
    size: int
    index: int

    def local(self, n: int) -> slice:
        """This rank's part of ``n`` features (``n`` divides by the size)."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


def _all_reduce(x: torch.Tensor, axis: TensorAxis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    if axis.group is not None:
        dist.all_reduce(y, op=op, group=axis.group)
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["bytes"] += y.numel() * y.element_size()
    return y


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TensorAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims, axis):
        top = _all_reduce(x.amax(dim=dims, keepdim=True), axis, dist.ReduceOp.MAX)
        ctx.save_for_backward(x, top)
        ctx.dims, ctx.axis = dims, axis
        return top

    @staticmethod
    def backward(ctx, grad):
        x, top = ctx.saved_tensors
        hit = x == top
        # one gradient for the global max, shared by every tie on every rank
        ties = _all_reduce(hit.sum(dim=ctx.dims, keepdim=True).to(grad.dtype), ctx.axis)
        whole = _all_reduce(grad, ctx.axis)
        return hit * (whole / ties), None, None


def copy_to_tensor(x: torch.Tensor, axis: TensorAxis) -> torch.Tensor:
    """Megatron's f: ``x`` forward, the group's sum of the gradient backward."""
    return _CopyToTensor.apply(x, axis)


def reduce_from_tensor(x: torch.Tensor, axis: TensorAxis) -> torch.Tensor:
    """Megatron's g: the group's sum forward, the gradient as it is backward."""
    return _ReduceFromTensor.apply(x, axis)


def tensor_amax(x: torch.Tensor, dims, axis: TensorAxis) -> torch.Tensor:
    """``x.amax(dims, keepdim=True)`` over the whole group's ``x`` (each rank
    holds its heads' part), differentiable."""
    return _TensorAmax.apply(x, tuple(dims), axis)


def gather_heads(local: torch.Tensor, heads: int, axis: TensorAxis) -> torch.Tensor:
    """Every rank's per-head maps [B, h_local, ...] as [B, heads, ...], in
    head order, on every rank."""
    whole = local.new_zeros((local.shape[0], heads) + tuple(local.shape[2:]))
    whole[:, axis.local(heads)] = local
    return reduce_from_tensor(whole, axis)
