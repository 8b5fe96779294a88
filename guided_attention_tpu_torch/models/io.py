"""Native checkpoints: the JAX package's msgpack parameter files.

A native checkpoint directory holds ``unet.msgpack``, ``text_encoder.msgpack``
and ``vae.msgpack``, each one component's flax parameter tree in flax's
msgpack format (the JAX package's ``models/io.py``), and optionally a
``tokenizer/`` folder. Either package writes it and either reads it:
the port through its own codec (``runtime/serialization``) and the
converters ``models/convert.params_to_jax`` / ``params_from_jax``.
Converting a diffusers directory is paid once (``python -m
guided_attention_tpu_torch.models.convert``); loading is then one read of
each file.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Union

from guided_attention_tpu_torch.models.convert import params_from_jax, params_to_jax
from guided_attention_tpu_torch.runtime import serialization

COMPONENTS = ("unet", "text_encoder", "vae")


def _modules(sd) -> Dict[str, Any]:
    if isinstance(sd, dict):
        return sd
    return {"unet": sd.unet, "text_encoder": sd.text_encoder, "vae": sd.vae}


def save_params(ckpt_dir: str, bundle_or_params: Union[Any, Dict[str, Any]]) -> int:
    """Write each component's tree to ``ckpt_dir/<component>.msgpack``:
    a ``StableDiffusion`` bundle's modules in the JAX package's layout, or a
    dict of such trees. Returns the number of tensors written."""
    params = bundle_or_params
    if not isinstance(params, dict):  # a bundle
        params = {name: params_to_jax(m, name) for name, m in _modules(bundle_or_params).items()}
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    n = 0
    for name, tree in params.items():
        # written beside the file and moved over it: a crash never leaves a torn file
        tmp = d / f".{name}.msgpack.tmp{os.getpid()}"
        serialization.dump(tree, tmp)
        os.replace(tmp, d / f"{name}.msgpack")
        n += _count_leaves(tree)
    return n


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def load_params(ckpt_dir: str, sd) -> None:
    """Fill the modules of ``sd`` (a ``StableDiffusion`` bundle, or a dict of
    its three modules by component name) from the native checkpoint
    ``ckpt_dir``; every component file must be there."""
    for name, module in _modules(sd).items():
        tree = serialization.load(os.path.join(ckpt_dir, f"{name}.msgpack"))
        module.load_state_dict(params_from_jax(tree, module, name))


def is_native_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and any(os.path.exists(os.path.join(path, f"{c}.msgpack")) for c in COMPONENTS)
