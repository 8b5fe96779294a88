"""The main path's workload, defined once for every script that drives it.

One guided 512x512 SD1.5 image: 50 DDIM steps, the two-object meta-prompt,
default thresholds and hyperparameters, decoded to uint8, bf16 weights
drawn at random from a seed (the compute is the full-width model's). A
measurement runs ``WARMUP_SEED`` once, then times ``TIMED_SEED``.
"""
from __future__ import annotations

import torch

from guided_attention_tpu_torch.models.bundle import StableDiffusion
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline, PipelineOutput

META_PROMPT = "a [robot:.6,.3,.4,.55] and a [blue vase:0,.3,.4,.55]"
STEPS = 50
WEIGHT_SEED = 0
WARMUP_SEED = 99
TIMED_SEED = 28


def create(device="cuda") -> GuidedAttentionPipeline:
    """SD1.5 in bf16 at full width, random weights from ``WEIGHT_SEED``."""
    sd = StableDiffusion.create("sd15", torch.bfloat16, device=device, seed=WEIGHT_SEED)
    return GuidedAttentionPipeline(sd)


def generate(pipe: GuidedAttentionPipeline, seed: int) -> PipelineOutput:
    """One guided image of the main path."""
    return pipe(meta_prompt=META_PROMPT, seed=seed, num_inference_steps=STEPS,
                decode=True, capture_diagnostics=False)
