"""StableDiffusion model bundle: UNet, text encoder, VAE, tokenizer.

``StableDiffusion.create(model, dtype, device, seed, checkpoint_dir)``
builds random-init weights at the preset's full width, from a seed, with
flax's default initializers (see ``models/layers.py``), or, given a
checkpoint directory, its weights: a native msgpack checkpoint first
(``models/io``, the JAX package's format, which either package writes),
else a diffusers directory (``models/convert.load_component_params``).
``load_jax_params`` fills the modules from
the JAX package's parameter trees (tests use it to give both packages the
same weights).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from guided_attention_tpu_torch.models.clip import CLIPTextModel
from guided_attention_tpu_torch.models.configs import StableDiffusionConfig, get_config
from guided_attention_tpu_torch.models.convert import load_component_params, params_from_jax
from guided_attention_tpu_torch.models.io import is_native_checkpoint, load_params
from guided_attention_tpu_torch.models.layers import cast_, init_flax_like_
from guided_attention_tpu_torch.models.tokenizer import load_tokenizer, pad_ids
from guided_attention_tpu_torch.models.unet import UNet2DCondition
from guided_attention_tpu_torch.models.vae import AutoencoderKL, latents_to_images


def resolve_device(device) -> torch.device:
    """The caller's device; a CUDA device without CUDA raises instead of
    falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class StableDiffusion:
    config: StableDiffusionConfig
    unet: UNet2DCondition
    text_encoder: CLIPTextModel
    vae: AutoencoderKL
    tokenizer: Any
    device: torch.device

    @classmethod
    def create(
        cls,
        model: str = "sd15",
        dtype: torch.dtype = torch.bfloat16,
        device: Any = "cuda",
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
    ) -> "StableDiffusion":
        """Bundle of a preset ("sd15", "sd21", "micro"): random init from
        ``seed``, or the weights of ``checkpoint_dir``: a native checkpoint
        (``unet.msgpack``, ``text_encoder.msgpack``, ``vae.msgpack``) or a
        diffusers directory (``unet``, ``text_encoder`` and ``vae``
        subfolders); its ``tokenizer`` subfolder where there is one."""
        return cls.from_config(get_config(model, dtype), device, seed, checkpoint_dir)

    @classmethod
    def from_config(cls, cfg: StableDiffusionConfig, device: Any = "cuda", seed: int = 0,
                    checkpoint_dir: Optional[str] = None) -> "StableDiffusion":
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        with dev:
            unet = UNet2DCondition(cfg.unet)
            clip = CLIPTextModel(cfg.clip)
            vae = AutoencoderKL(cfg.vae)
        for m in (unet, clip, vae):
            init_flax_like_(m, gen)
        clip.init_position_embedding_(gen)
        cast_(unet, cfg.unet.dtype, cfg.unet.norm_dtype)
        cast_(clip, cfg.clip.dtype)
        cast_(vae, cfg.vae.dtype)
        tokenizer_dir = None
        if checkpoint_dir is not None and is_native_checkpoint(checkpoint_dir):
            load_params(checkpoint_dir, {"unet": unet, "text_encoder": clip, "vae": vae})
        elif checkpoint_dir is not None:
            for name, module in (("unet", unet), ("text_encoder", clip), ("vae", vae)):
                module.load_state_dict(load_component_params(checkpoint_dir, name, module))
        if checkpoint_dir is not None and os.path.isdir(os.path.join(checkpoint_dir, "tokenizer")):
            tokenizer_dir = checkpoint_dir
        for m in (unet, clip, vae):
            m.eval()
        return cls(cfg, unet, clip, vae, load_tokenizer(tokenizer_dir), dev)

    def load_jax_params(self, params: Dict[str, Any]) -> None:
        """Fill the modules from the JAX package's ``params`` tree
        ({"unet", "text_encoder", "vae"}, numpy or jax leaves)."""
        for name, module in (("unet", self.unet), ("text_encoder", self.text_encoder), ("vae", self.vae)):
            module.load_state_dict(params_from_jax(params[name], module, name))

    # --- prompt encoding (reference _encode_prompt, pipeline:64-199) ---
    def tokenize(self, text: str) -> torch.Tensor:
        return torch.tensor([pad_ids(self.tokenizer, text)], dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative_prompt: str = "") -> torch.Tensor:
        """Embeddings [2, 77, D]: row 0 uncond, row 1 cond."""
        ids = torch.cat([self.tokenize(negative_prompt), self.tokenize(prompt)], dim=0)
        return self.text_encoder(ids)

    @torch.no_grad()
    def decode_latents(self, latents_nhwc: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B,h,w,4] -> images [B,H,W,3] in [0,1], model dtype."""
        z = latents_nhwc / self.config.vae.scaling_factor
        return latents_to_images(self.vae.decode(z))

    @torch.no_grad()
    def decode_latents_u8(self, latents_nhwc: torch.Tensor) -> torch.Tensor:
        """decode_latents quantized to uint8 on the device."""
        return torch.round(self.decode_latents(latents_nhwc).float() * 255.0).to(torch.uint8)
