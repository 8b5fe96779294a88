"""JAX-package parameter trees -> the port's state dicts.

``params_from_jax`` is the inverse of the JAX package's ``models/convert.py``:
it takes one component's flax parameter tree with numpy leaves (flax names
such as ``down_blocks_0_resnets_0/conv1/kernel``, HWIO conv kernels and
``[in, out]`` dense kernels) and fills every key of the port's module
(diffusers names such as ``down_blocks.0.resnets.0.conv1.weight``, OIHW
convs, ``[out, in]`` linears). Matching is by the underscore-joined name, as
the forward converter matches. Leaves the port has no module for (the VAE
encoder) are ignored; a port key with no flax leaf raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

# CLIP: the flax tree is flat under the model root, the port's keys carry
# transformers' text_model.encoder / text_model.embeddings wrappers
_TEXT_STRIPS = ("text_model.", "encoder.", "embeddings.")


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.extend(_flatten(v, prefix + (k,)))
    else:
        out.append((prefix, tree))
    return out


def _normalize_key(key: str, component: str) -> str:
    if component == "text_encoder":
        for pref in _TEXT_STRIPS:
            key = key.replace(pref, "")
    return key.replace(".", "_")


def _to_torch_layout(a: np.ndarray, flax_leaf: str, shape) -> np.ndarray:
    if flax_leaf == "kernel":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if tuple(a.shape) != tuple(shape):
        a = a.reshape(shape)
    return a


def params_from_jax(np_params: Dict[str, Any], module: nn.Module, component: str) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` (one of unet / text_encoder / vae) from the
    JAX package's parameter tree of the same component."""
    index = {"_".join(path): (path[-1], np.asarray(leaf)) for path, leaf in _flatten(np_params)}
    leaf_names = {"weight": ("kernel", "scale", "embedding"), "bias": ("bias",)}
    out: Dict[str, torch.Tensor] = {}
    missing = []
    for key, ref in module.state_dict().items():
        norm = _normalize_key(key, component)
        base, leaf = norm.rsplit("_", 1)
        cands = [f"{base}_{fl}" for fl in leaf_names.get(leaf, ())] + [norm, base]
        hit = next((index[c] for c in cands if c in index), None)
        if hit is None:
            missing.append(key)
            continue
        flax_leaf, arr = hit
        arr = _to_torch_layout(arr, flax_leaf, ref.shape)
        out[key] = torch.tensor(np.array(arr), dtype=ref.dtype, device=ref.device)
    if missing:
        raise ValueError(f"{component}: {len(missing)} port keys without a JAX leaf, e.g. {missing[:8]}")
    return out
