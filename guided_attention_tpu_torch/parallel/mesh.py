"""The process mesh and the tensor-parallel rules.

Counterpart of the JAX package's ``parallel/mesh.py``, over processes in
place of devices (one process drives one GPU: ``parallel/multihost.py``):

  * **data** axis: each rank generates its own samples (seeds and/or
    prompts); the guidance losses are per sample, so this is pure data
    parallelism with no communication until the final gather.
  * **tensor** axis: Megatron-style sharding of the UNet transformer's
    projections by ``DEFAULT_TP_RULES`` (q/k/v and the GEGLU input by output
    features, the attention output and the GEGLU output by input features).
    The ranks of one data row form a tensor group (``multihost.
    tensor_groups``: NCCL, or gloo where ranks share a card); each runs its
    heads, with the collectives of ``parallel/tensor.py`` where the partial
    results meet. ``shard_unet`` gives a rank its slices. Convolutions,
    norms, the text encoder and the VAE stay replicated, as in the JAX
    package, and so does an attention layer whose heads (or a feed-forward
    whose width) the axis does not divide.
"""
from __future__ import annotations

import copy
import dataclasses
import re
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from guided_attention_tpu_torch.parallel.multihost import process_count, process_index, tensor_groups
from guided_attention_tpu_torch.parallel.tensor import TensorAxis

AXES = ("data", "tensor")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the process group, in rank order:
    ``ranks[i, j]`` is the rank at data index i, tensor index j."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0  # this process's
    # this rank's tensor group and its backend ("nccl" or "gloo"); None
    # without a tensor axis
    tensor_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    tensor_backend: Optional[str] = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def ranks(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.sizes)

    def _index(self, axis: str, rank: Optional[int] = None) -> int:
        if axis not in self.axis_names:
            return 0
        where = np.argwhere(self.ranks == (self.rank if rank is None else rank))[0]
        return int(where[self.axis_names.index(axis)])

    @property
    def data_index(self) -> int:
        """This rank's data row: the rows of a batch it runs."""
        return self._index("data")

    @property
    def tensor_index(self) -> int:
        """This rank's place in its tensor group: its slice of the heads."""
        return self._index("tensor")

    @property
    def tensor_rows(self):
        """The tensor groups: per data index, its ranks in tensor order."""
        d = self.shape.get("data", 1)
        return [sorted((r for r in range(self.size) if self._index("data", r) == i),
                       key=lambda r: self._index("tensor", r)) for i in range(d)]

    @property
    def row_sources(self):
        """One rank per data row, in data order (tensor index 0): the ranks
        whose rows a gather keeps."""
        return [row[0] for row in self.tensor_rows]

    @property
    def tensor_axis(self) -> Optional[TensorAxis]:
        """This rank's place on the tensor axis; None without one."""
        t = self.shape.get("tensor", 1)
        return TensorAxis(self.tensor_group, t, self.tensor_index) if t > 1 else None


def make_mesh(shape: Optional[Dict[str, int]] = None, device: Any = None) -> Mesh:
    """A mesh over the process group, by default pure data parallelism over
    every process (``{"data": world_size}``). The axes are "data" and
    "tensor", and data x tensor must equal the group's size. With a tensor
    axis this is a collective call (every rank makes it): it makes the
    tensor groups, whose backend depends on where each rank's tensors live,
    ``device`` (default: the current CUDA device, else the CPU)."""
    n = process_count()
    shape = dict(shape) if shape else {"data": n}
    unknown = [a for a in shape if a not in AXES]
    if unknown:
        raise ValueError(f"mesh axes must be among {AXES}, got {unknown}")
    sizes = tuple(int(v) for v in shape.values())
    if any(v < 1 for v in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {shape} needs {int(np.prod(sizes))} processes; the process group has {n} "
                         "(torch.distributed world size)")
    mesh = Mesh(tuple(shape), sizes, process_index())
    if shape.get("tensor", 1) == 1:
        return mesh
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    group, backend = tensor_groups(mesh.tensor_rows, device)
    return dataclasses.replace(mesh, tensor_group=group, tensor_backend=backend)


# (regex over the '.'-joined parameter name of the UNet, partition over the
# tensor's dims: one axis name or None per dim) - first match wins. torch's
# Linear weight is [out, in], the transpose of flax's kernel, so the JAX
# package's P(None, "tensor") on a kernel is ("tensor", None) here.
DEFAULT_TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*\.attn[12]\.to_[qkv]\.weight$", ("tensor", None)),
    (r".*\.attn[12]\.to_out\.0\.weight$", (None, "tensor")),
    (r".*\.attn[12]\.to_out\.0\.bias$", (None,)),
    (r".*\.ff\.net\.0\.proj\.weight$", ("tensor", None)),
    (r".*\.ff\.net\.0\.proj\.bias$", ("tensor",)),
    (r".*\.ff\.net\.2\.weight$", (None, "tensor")),
)


def tp_spec(name: str, rules=DEFAULT_TP_RULES) -> Optional[Tuple[Optional[str], ...]]:
    """The partition a parameter of the UNet takes on the tensor axis, or
    None (replicated)."""
    for pat, spec in rules:
        if re.match(pat, name):
            return spec
    return None


def _sharded_copy(w: torch.Tensor, dim: int, axis: TensorAxis, halves: int = 1) -> nn.Parameter:
    """This rank's slice of ``w`` along ``dim``: of each of ``halves`` equal
    consecutive blocks (GEGLU's [hidden; gate] projection has two), the
    rank's part, the parts concatenated in block order."""
    blocks = w.detach().chunk(halves, dim=dim)
    part = [b.narrow(dim, axis.local(b.shape[dim]).start, b.shape[dim] // axis.size) for b in blocks]
    return nn.Parameter(torch.cat(part, dim=dim).contiguous(), requires_grad=w.requires_grad)


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, leaf = name.rsplit(".", 1)
    return root.get_submodule(path), leaf


def shard_unet(unet: nn.Module, mesh: Mesh) -> nn.Module:
    """A UNet whose parameters that ``DEFAULT_TP_RULES`` name are this
    rank's slices on ``mesh``'s tensor axis, and whose attention and
    feed-forward layers run on them (their ``tp``). ``unet`` itself is not
    changed, and the copy shares every replicated parameter with it. A
    layer whose head count (a feed-forward: whose width) the axis does not
    divide stays replicated, and is named on stderr. Without a tensor axis,
    ``unet`` itself."""
    from guided_attention_tpu_torch.models.unet import CrossAttention, FeedForward

    axis = mesh.tensor_axis
    if axis is None:
        return unet
    memo = {id(t): t for t in list(unet.parameters()) + list(unet.buffers())}
    out = copy.deepcopy(unet, memo)
    replicated = []
    for prefix, mod in out.named_modules():
        if isinstance(mod, CrossAttention):
            width = mod.heads
        elif isinstance(mod, FeedForward):
            width = mod.net[2].weight.shape[1]
        else:
            continue
        if width % axis.size:
            replicated.append(prefix)
            continue
        for name, p in list(mod.named_parameters()):
            spec = tp_spec(f"{prefix}.{name}")
            if spec is None or "tensor" not in spec:
                continue  # a replicated bias is added once, after the sum (the layer's forward)
            owner, leaf = _owner(mod, name)
            halves = 2 if name.startswith("net.0.proj.") else 1
            setattr(owner, leaf, _sharded_copy(p, spec.index("tensor"), axis, halves))
        mod.tp = axis
    if replicated:
        print(f"rank {mesh.rank}: the tensor axis ({axis.size}) divides no heads (feed-forward: width) of "
              f"{len(replicated)} layer(s), which stay replicated: {', '.join(replicated)}",
              file=sys.stderr, flush=True)
    return out
