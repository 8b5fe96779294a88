"""The plain PyTorch reference that decides a run's ``correct``.

A frozen, self-contained copy of the guided Stable Diffusion computation
(tokenizer, CLIP text encoder, UNet with cross-map capture, guidance loss
and its latent gradient, refinement and gate updates, DDIM, re-noise, VAE
decoder) in float32 plain tensor code: no kernel, no cache, no batching of
its own. It imports nothing of the program under test, nor JAX.

Every product (linear, convolution, attention scores and values) passes its
operands through a ``Precision``: float32 as they are for the reference,
or rounded to float8 e4m3 with a per-tensor scale for the control
(``Precision("fp8")``), the precision one step below the bf16 the
configurations state.
"""
