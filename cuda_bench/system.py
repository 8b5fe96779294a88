"""The system under test: the port's pipeline, built from a configuration
file with weights the benchmark makes from the seed.

The weights are drawn on the device in one call per dtype, from a
``torch.Generator`` seeded with the run's seed, in the dtype each tensor is
served in (the port's bf16, its norms float32), then scaled tensor by
tensor on the device: matrices and kernels N(0, 1/fan_in), token
embeddings N(0, 1/dim), CLIP's position table N(0, 0.01^2), biases 0,
norm scales 1. The port's modules are built without storage (on the
"meta" device) and take these tensors as their parameters; the reference
is handed the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

COMPONENTS = ("unet", "text_encoder", "vae")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _port_modules(preset: str, dtype: torch.dtype):
    from guided_attention_tpu_torch.models.clip import CLIPTextModel
    from guided_attention_tpu_torch.models.configs import get_config
    from guided_attention_tpu_torch.models.layers import cast_
    from guided_attention_tpu_torch.models.unet import UNet2DCondition
    from guided_attention_tpu_torch.models.vae import AutoencoderKL

    cfg = get_config(preset, dtype)
    with torch.device("meta"):
        mods = {"unet": UNet2DCondition(cfg.unet), "text_encoder": CLIPTextModel(cfg.clip),
                "vae": AutoencoderKL(cfg.vae)}
    cast_(mods["unet"], cfg.unet.dtype, cfg.unet.norm_dtype)
    cast_(mods["text_encoder"], cfg.clip.dtype)
    cast_(mods["vae"], cfg.vae.dtype)
    return cfg, mods


def _init_of(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one parameter."""
    if name.endswith("bias"):
        return 0.0, 0.0
    if len(shape) == 1:  # norm scales
        return 1.0, 0.0
    if "position_embedding" in name:
        return 0.0, 0.01
    if "token_embedding" in name:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(meta: Dict[str, torch.nn.Module], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{component: {name: tensor}} shaped and typed as ``meta``'s
    parameters, drawn from ``seed``: one normal draw per dtype into a flat
    buffer, whose slices become the tensors."""
    entries = [(c, n, t.shape, t.dtype) for c in COMPONENTS for n, t in meta[c].state_dict().items()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, Dict[str, torch.Tensor]] = {c: {} for c in COMPONENTS}
    for dtype in sorted({e[3] for e in entries}, key=str):
        group = [e for e in entries if e[3] == dtype]
        flat = torch.randn(sum(math.prod(e[2]) for e in group), generator=gen, device=device, dtype=dtype)
        off = 0
        for comp, name, shape, _ in group:
            n = math.prod(shape)
            view = flat[off:off + n].view(shape)
            off += n
            mean, std = _init_of(name, tuple(shape))
            if std == 0.0:
                view.fill_(mean)
            else:
                view.mul_(std)
            out[comp][name] = view
    return out


def build(config: Dict, seed: int, device="cuda"):
    """(pipeline, weights): the port's ``GuidedAttentionPipeline`` on the
    preset ``config["preset"]`` holding the weights drawn from ``seed``."""
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.models.tokenizer import load_tokenizer
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline

    cfg, mods = _port_modules(config["preset"], DTYPES[config["dtype"]])
    weights = make_weights(mods, seed, device)
    for comp in COMPONENTS:
        mods[comp].load_state_dict(weights[comp], assign=True)
        mods[comp].requires_grad_(False)
        mods[comp].eval()
    sd = StableDiffusion(cfg, mods["unet"], mods["text_encoder"], mods["vae"], load_tokenizer(None),
                         torch.device(device))
    return GuidedAttentionPipeline(sd), weights
