"""The main path's workload, defined once for every script that drives it.

One guided 512x512 SD1.5 image: 50 DDIM steps, the two-object meta-prompt,
default thresholds and hyperparameters, decoded to uint8, bf16 weights
drawn at random from a seed (the compute is the full-width model's). A
measurement runs ``WARMUP_SEED`` once, then times ``TIMED_SEED``.

The batch path is the same generation for several samples at once
(``GuidedAttentionPipeline.generate_batch``): ``BATCH_SEEDS``, B = 4, two
seeds under each of the two ``BATCH_PROMPTS``, which bind the same two
groups to other boxes (the JAX package's ``scripts/perf_batch.py``).

With ``create(model="sd21")`` the same generation runs on SD2.1-base;
``generate`` and ``generate_batch`` then pass ``sd_2_1=True``, so that the
guidance normalizes over the prompt's tokens up to its end-of-text token,
as the CLI's ``--sd_2_1`` does (``sd_2_1`` follows the bundle's preset).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from guided_attention_tpu_torch.models.bundle import StableDiffusion
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline, PipelineOutput

META_PROMPT = "a [robot:.6,.3,.4,.55] and a [blue vase:0,.3,.4,.55]"
STEPS = 50
WEIGHT_SEED = 0
WARMUP_SEED = 99
TIMED_SEED = 28
BATCH_PROMPTS = (META_PROMPT, "a [robot:0,.1,.45,.5] and a [blue vase:.55,.4,.4,.5]")
BATCH_SEEDS = (TIMED_SEED, TIMED_SEED, TIMED_SEED + 1, TIMED_SEED + 1)


def create(device="cuda", model: str = "sd15", dtype: torch.dtype = torch.bfloat16) -> GuidedAttentionPipeline:
    """The preset (SD1.5 by default) in ``dtype`` at full width, random
    weights from ``WEIGHT_SEED``."""
    sd = StableDiffusion.create(model, dtype, device=device, seed=WEIGHT_SEED)
    return GuidedAttentionPipeline(sd)


def is_sd21(pipe: GuidedAttentionPipeline) -> bool:
    """Whether the pipeline's bundle is the SD2.1 preset."""
    return pipe.sd.config.name == "sd21"


def generate(pipe: GuidedAttentionPipeline, seed: int, steps: int = STEPS) -> PipelineOutput:
    """One guided image of the main path (``steps`` DDIM steps)."""
    return pipe(meta_prompt=META_PROMPT, seed=seed, num_inference_steps=steps, sd_2_1=is_sd21(pipe),
                decode=True, capture_diagnostics=False)


def batch_prompts(n: int) -> List[str]:
    """``BATCH_PROMPTS`` in turn, one per sample."""
    return [BATCH_PROMPTS[b % len(BATCH_PROMPTS)] for b in range(n)]


def generate_batch(pipe: GuidedAttentionPipeline, seeds: Sequence[int] = BATCH_SEEDS,
                   meta_prompts: Optional[Sequence[str]] = None, steps: int = STEPS, decode: bool = True,
                   **kwargs) -> List[PipelineOutput]:
    """One batch of the main path's generation, one image per seed, the
    prompts ``batch_prompts`` unless ``meta_prompts`` names them; other
    keywords go to ``generate_batch``."""
    prompts = list(meta_prompts) if meta_prompts is not None else batch_prompts(len(seeds))
    kwargs.setdefault("sd_2_1", is_sd21(pipe))
    return pipe.generate_batch(list(seeds), meta_prompts=prompts, num_inference_steps=steps,
                               decode=decode, capture_diagnostics=False, **kwargs)
