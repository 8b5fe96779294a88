"""PyTorch + CUDA port of guided_attention_tpu for NVIDIA Hopper.

Guided Stable Diffusion generation with hand-written CUDA kernels for the
attention paths that the JAX package ran as Pallas TPU kernels. The package
imports torch and never jax or the JAX package; every entry point runs on
``device="cuda"`` unless the caller passes another device.
"""
from guided_attention_tpu_torch.config import HyperParams  # noqa: F401
from guided_attention_tpu_torch.models.bundle import StableDiffusion  # noqa: F401
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline, PipelineOutput  # noqa: F401
