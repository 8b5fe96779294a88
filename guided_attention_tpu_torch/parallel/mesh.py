"""The process mesh and the tensor-parallel rules.

Counterpart of the JAX package's ``parallel/mesh.py``, over processes in
place of devices (one process drives one GPU: ``parallel/multihost.py``):

  * **data** axis: each rank generates its own samples (seeds and/or
    prompts); the guidance losses are per sample, so this is pure data
    parallelism with no communication until the final gather. The port runs
    it.
  * **tensor** axis: Megatron-style sharding of the UNet transformer's
    projections (q/k/v and the GEGLU input by output features, the
    attention output and the GEGLU output by input features), which needs
    device collectives and a head-split cross-attention map for K3. Not in
    the port yet: a mesh with ``tensor > 1`` raises. ``DEFAULT_TP_RULES``
    keeps the JAX package's rules, in the port's parameter names, for it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np

from guided_attention_tpu_torch.parallel.multihost import process_count

AXES = ("data", "tensor")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the process group, in rank order:
    ``ranks[i, j]`` is the rank at data index i, tensor index j."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def ranks(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.sizes)


def make_mesh(shape: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over the process group, by default pure data parallelism over
    every process (``{"data": world_size}``). The axes are "data" and
    "tensor", and data x tensor must equal the group's size."""
    n = process_count()
    shape = dict(shape) if shape else {"data": n}
    unknown = [a for a in shape if a not in AXES]
    if unknown:
        raise ValueError(f"mesh axes must be among {AXES}, got {unknown}")
    sizes = tuple(int(v) for v in shape.values())
    if any(v < 1 for v in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if shape.get("tensor", 1) > 1:
        raise NotImplementedError(
            "the mesh's tensor axis (Megatron-style UNet projections over several GPUs) is not in the PyTorch "
            "port yet: ROADMAP.md Queue 1 item 7")
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {shape} needs {int(np.prod(sizes))} processes; the process group has {n} "
                         "(torch.distributed world size)")
    return Mesh(tuple(shape), sizes)


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
