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
the forward converter matches. A port key with no flax leaf raises. Its
leaves may be numpy arrays (bfloat16 ones through ml_dtypes too) or torch
tensors, as the port's msgpack codec gives bfloat16 leaves.

``params_to_jax`` goes the other way: the JAX package's nested tree of one
component from the port's module, with flax's module names (a block and
its index are one name, ``down_blocks_0_attentions_0``; a transformer
block, ``transformer_blocks_0``, one level below), ``kernel`` leaves in
flax's layout (HWIO convolutions, ``[in, out]`` dense kernels), ``scale``
and ``embedding`` leaves, and the VAE's ``encoder`` / ``decoder``.
``models/io.save_params`` writes it; the JAX package's ``load_params``
reads it.

``main`` is the offline converter (``python -m
guided_attention_tpu_torch.models.convert <hf_dir> <out_dir>``): a diffusers
directory to a native msgpack one.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

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


def _leaf_tensor(leaf) -> torch.Tensor:
    """A parameter leaf (torch tensor, numpy array, bfloat16 included, or
    any array numpy can read) as a CPU-or-device torch tensor, no copy
    where the leaf allows it."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16: torch reads its bits
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _to_torch_layout(t: torch.Tensor, flax_leaf: str, shape) -> torch.Tensor:
    if flax_leaf == "kernel":
        if t.dim() == 2:
            t = t.t()
        elif t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if tuple(t.shape) != tuple(shape):
        t = t.reshape(shape)
    return t


def params_from_jax(np_params: Dict[str, Any], module: nn.Module, component: str) -> Dict[str, torch.Tensor]:
    """State dict for ``module`` (one of unet / text_encoder / vae) from the
    JAX package's parameter tree of the same component (numpy, jax or
    torch leaves)."""
    index = {"_".join(path): (path[-1], leaf) for path, leaf in _flatten(np_params)}
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
        t = _to_torch_layout(_leaf_tensor(arr), flax_leaf, ref.shape)
        out[key] = t.to(dtype=ref.dtype, device=ref.device).contiguous()
    if missing:
        raise ValueError(f"{component}: {len(missing)} port keys without a JAX leaf, e.g. {missing[:8]}")
    return out


# flax module names that join several dotted parts of a port key: a block
# and its index (``down_blocks.0.attentions.0`` is ``down_blocks_0_attentions_0``),
# an indexed layer (``transformer_blocks.0``, ``to_out.0``, ``layers.0``), and
# the VAE's up/down samplers, whose conv is part of the name there (the
# UNet's is a level below). First match at a part boundary wins.
_BLOCK = r"(?:down_blocks|up_blocks)\.\d+\.(?:attentions|resnets|downsamplers|upsamplers)\.\d+"
_GROUPS = {
    "unet": (_BLOCK, r"mid_block\.(?:attentions|resnets)\.\d+", r"transformer_blocks\.\d+", r"to_out\.\d+",
             r"net\.\d+\.proj", r"net\.\d+"),
    "text_encoder": (r"layers\.\d+", r"mlp\.fc\d+"),
    "vae": (r"(?:down_blocks|up_blocks)\.\d+\.(?:downsamplers|upsamplers)\.\d+\.conv", _BLOCK,
            r"mid_block\.(?:attentions|resnets)\.\d+", r"to_out\.\d+"),
}
_GROUP_RES = {c: re.compile("|".join(f"(?:{g})" for g in gs)) for c, gs in _GROUPS.items()}


def _flax_path(key: str, component: str) -> Tuple[str, ...]:
    """The flax module path of a port key's owner (the key without its
    leaf), e.g. ``down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj``
    -> (``down_blocks_0_attentions_0``, ``transformer_blocks_0``, ``ff``,
    ``net_0_proj``)."""
    if component == "text_encoder":
        for pref in _TEXT_STRIPS:
            key = key.replace(pref, "")
    parts = key.split(".")
    path, i = [], 0
    while i < len(parts):
        rest = ".".join(parts[i:])
        m = _GROUP_RES[component].match(rest)
        if m and (m.end() == len(rest) or rest[m.end()] == "."):
            path.append(m.group(0).replace(".", "_"))
            i += m.group(0).count(".") + 1
        else:
            path.append(parts[i])
            i += 1
    return tuple(path)


def _jax_leaves(module: nn.Module, component: str):
    """Each parameter of ``module`` as (its flax path, leaf name last; the
    tensor in flax's layout, on the module's device)."""
    for key, value in module.state_dict().items():
        owner_key, leaf = key.rsplit(".", 1)
        owner = module.get_submodule(owner_key)
        path = _flax_path(owner_key, component)
        t = value.detach()
        if leaf == "bias":
            name = "bias"
        elif isinstance(owner, (nn.Linear, nn.Conv2d)):
            name = "kernel"
            t = t.t() if t.dim() == 2 else t.permute(2, 3, 1, 0)  # [out, in] -> [in, out]; OIHW -> HWIO
        elif isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            name = "scale"
        elif isinstance(owner, nn.Embedding) and path[-1] != "position_embedding":
            name = "embedding"
        else:  # a raw parameter (CLIP's position_embedding): the leaf is the module's name
            path, name = path[:-1], path[-1]
        yield path + (name,), t


def params_to_jax(module: nn.Module, component: str) -> Dict[str, Any]:
    """The JAX package's parameter tree of ``component`` (unet /
    text_encoder / vae) from the port's ``module``: nested dicts of CPU
    torch tensors in flax's layout and the module's dtypes."""
    tree: Dict[str, Any] = {}
    for path, t in _jax_leaves(module, component):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.contiguous().cpu()  # one device-to-host copy, already in flax's layout
    return tree


def main(argv: Optional[List[str]] = None) -> None:
    """Offline converter: a diffusers checkpoint directory to a native
    msgpack one (``unet.msgpack``, ``text_encoder.msgpack``,
    ``vae.msgpack`` in the JAX package's layout), with ``tokenizer/``
    copied along. ``StableDiffusion.create(model, checkpoint_dir=<out_dir>)``
    (either package's) then reads it without converting again."""
    import argparse

    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.models.io import save_params

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("hf_dir", help="diffusers-format checkpoint directory")
    parser.add_argument("out_dir", help="output directory for the native msgpack parameters")
    parser.add_argument("--model", default="sd15", choices=["sd15", "sd14", "sd21", "micro"])
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--device", default="cuda", help="where the bundle is built (cuda or cpu)")
    args = parser.parse_args(argv)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    sd = StableDiffusion.create(args.model, dtype, device=args.device, checkpoint_dir=args.hf_dir)
    n = save_params(args.out_dir, sd)
    # the tokenizer goes along, so that the native directory is a full drop-in
    tok_src = os.path.join(args.hf_dir, "tokenizer")
    if os.path.isdir(tok_src):
        shutil.copytree(tok_src, os.path.join(args.out_dir, "tokenizer"), dirs_exist_ok=True)
    print(f"converted {n} tensors -> {args.out_dir}")


if __name__ == "__main__":
    main()
