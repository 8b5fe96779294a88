"""Model presets: SD 1.4/1.5, SD 2.1-base, and a micro config for tests."""
from __future__ import annotations

import dataclasses

import torch

from guided_attention_tpu_torch.models.clip import CLIPTextConfig
from guided_attention_tpu_torch.models.unet import UNetConfig
from guided_attention_tpu_torch.models.vae import VAEConfig


@dataclasses.dataclass(frozen=True)
class StableDiffusionConfig:
    name: str
    unet: UNetConfig
    clip: CLIPTextConfig
    vae: VAEConfig
    latent_size: int = 64
    image_size: int = 512


def sd15_config(dtype: torch.dtype = torch.bfloat16) -> StableDiffusionConfig:
    """SD 1.4 / 1.5 architecture (they share it)."""
    return StableDiffusionConfig(
        name="sd15",
        unet=UNetConfig(dtype=dtype, use_flash_attention=True),
        clip=CLIPTextConfig(dtype=dtype),
        vae=VAEConfig(dtype=dtype),
    )


def sd21_config(dtype: torch.dtype = torch.bfloat16) -> StableDiffusionConfig:
    """stabilityai/stable-diffusion-2-1-base (512px, epsilon prediction)."""
    return StableDiffusionConfig(
        name="sd21",
        unet=UNetConfig(
            cross_attention_dim=1024,
            num_heads=(5, 10, 20, 20),  # head_dim 64
            use_linear_projection=True,
            use_flash_attention=True,
            dtype=dtype,
        ),
        clip=CLIPTextConfig(
            hidden_size=1024,
            num_layers=23,  # checkpoint truncated to the penultimate layer
            num_heads=16,
            intermediate_size=4096,
            hidden_act="gelu",
            dtype=dtype,
        ),
        vae=VAEConfig(dtype=dtype),
    )


def micro_config(dtype: torch.dtype = torch.float32) -> StableDiffusionConfig:
    """Tiny random-init model with the same block structure, for tests."""
    return StableDiffusionConfig(
        name="micro",
        unet=UNetConfig(
            sample_size=16,
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=64,
            num_heads=(2, 2, 2, 2),
            norm_num_groups=8,
            dtype=dtype,
        ),
        clip=CLIPTextConfig(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128, dtype=dtype),
        vae=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8, dtype=dtype),
        latent_size=16,
        image_size=128,
    )


def get_config(name: str, dtype: torch.dtype = torch.bfloat16) -> StableDiffusionConfig:
    if name in ("sd14", "sd15", "sd1", "sd"):
        return sd15_config(dtype)
    if name in ("sd21", "sd2", "sd21base"):
        return sd21_config(dtype)
    if name == "micro":
        return micro_config(dtype)
    raise ValueError(f"unknown model config {name!r}")
