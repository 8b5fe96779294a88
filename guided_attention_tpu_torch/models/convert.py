"""Checkpoints and JAX-package parameter trees -> the port's state dicts.

``load_component_params`` reads one component of a diffusers checkpoint
directory (``unet``, ``text_encoder`` or ``vae``; safetensors first, a
torch ``.bin`` after, as the JAX package's ``models/convert.py`` does) into
a state dict of the port's module. The port's module names are diffusers'
keys, so the mapping is by name: legacy (diffusers <= 0.12) VAE attention
names ``query/key/value/proj_attn/norm`` become ``to_q/to_k/to_v/to_out.0/
group_norm``, transformers' ``position_ids`` buffer is skipped, and a
legacy attention projection stored as a 1x1 conv is reshaped to its linear.

``params_from_jax`` is the inverse of the JAX package's ``models/convert.py``:
it takes one component's flax parameter tree with numpy leaves (flax names
such as ``down_blocks_0_resnets_0/conv1/kernel``, HWIO conv kernels and
``[in, out]`` dense kernels) and fills every key of the port's module
(diffusers names such as ``down_blocks.0.resnets.0.conv1.weight``, OIHW
convs, ``[out, in]`` linears). Matching is by the underscore-joined name, as
the forward converter matches. A port key with no flax leaf raises.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

# CLIP: the flax tree is flat under the model root, the port's keys carry
# transformers' text_model.encoder / text_model.embeddings wrappers
_TEXT_STRIPS = ("text_model.", "encoder.", "embeddings.")


# legacy diffusers<=0.12 VAE attention names -> the port's (modern) names,
# on the dotted key and only for the vae: the UNet's transformer blocks own
# a GroupNorm named plain ``norm``
_LEGACY_VAE_RENAMES = (
    (re.compile(r"\bquery\b"), "to_q"),
    (re.compile(r"\bkey\b"), "to_k"),
    (re.compile(r"\bvalue\b"), "to_v"),
    (re.compile(r"\bproj_attn\b"), "to_out.0"),
    (re.compile(r"\bnorm\b"), "group_norm"),
)


def load_state_dict_file(dirpath: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a diffusers component directory, on the CPU:
    ``*.safetensors`` if there is one, else ``*.bin``."""
    for fname in ("diffusion_pytorch_model.safetensors", "model.safetensors", "pytorch_model.safetensors"):
        path = os.path.join(dirpath, fname)
        if os.path.exists(path):
            from safetensors.torch import load_file

            return load_file(path, device="cpu")
    for fname in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
        path = os.path.join(dirpath, fname)
        if os.path.exists(path):
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model weights found under {dirpath}")


def checkpoint_state_dict(sd: Dict[str, torch.Tensor], module: nn.Module, component: str) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` from a diffusers state dict ``sd`` of the
    same component, in the module's dtypes and on its device. Raises on a
    module key the checkpoint lacks or a checkpoint key the module lacks."""
    ref = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for key, value in sd.items():
        if key.endswith("position_ids"):  # transformers' buffer, not a parameter
            continue
        name = key
        if component == "vae":
            for pat, new in _LEGACY_VAE_RENAMES:
                name = pat.sub(new, name)
        if name not in ref:
            unmatched.append(key)
            continue
        target = ref[name]
        if tuple(value.shape) != tuple(target.shape):
            value = value.reshape(target.shape)  # a [C, C, 1, 1] conv projection as a linear
        out[name] = value.to(dtype=target.dtype, device=target.device)
    missing = sorted(set(ref) - set(out))
    if missing or unmatched:
        raise ValueError(
            f"{component}: {len(missing)} module keys missing from the checkpoint, e.g. {missing[:8]}; "
            f"{len(unmatched)} checkpoint keys without a module, e.g. {unmatched[:8]}"
        )
    return out


def load_component_params(checkpoint_dir: str, subfolder: str, module: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` from ``checkpoint_dir/subfolder`` of a
    diffusers checkpoint directory."""
    sd = load_state_dict_file(os.path.join(checkpoint_dir, subfolder))
    return checkpoint_state_dict(sd, module, subfolder)


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
