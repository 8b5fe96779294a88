"""Shared by the port's parity tests: the JAX package's micro bundle with
parameters drawn by numpy from a seed.

``StableDiffusion.create`` jits the models' init functions, which costs
about 40 s of XLA:CPU compile in every test process. Here the parameter
tree's shapes come from ``jax.eval_shape`` (a trace, no compile) and the
values from numpy: kernels lecun-normal like flax's default, and biases
and norm scales drawn too (flax starts them at 0 and 1), so that a bias or
scale that lands in the wrong place on the port's side changes the result.
"""
import numpy as np
import jax
import jax.numpy as jnp

from guided_attention_tpu.models.bundle import StableDiffusion
from guided_attention_tpu.models.clip import CLIPTextModel
from guided_attention_tpu.models.configs import get_config
from guided_attention_tpu.models.tokenizer import load_tokenizer
from guided_attention_tpu.models.unet import UNet2DCondition
from guided_attention_tpu.models.vae import AutoencoderKL


def _draw(rng, name: str, shape) -> np.ndarray:
    if name == "kernel":  # Dense [in, out] and Conv HWIO: variance 1 / fan_in
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "bias":
        return 0.1 * rng.standard_normal(shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    return rng.standard_normal(shape) / np.sqrt(shape[-1])  # embeddings


def jax_micro_bundle(seed: int = 0) -> StableDiffusion:
    """The JAX package's micro StableDiffusion in float32, random weights."""
    cfg = get_config("micro", jnp.float32)
    unet, clip, vae = UNet2DCondition(cfg.unet), CLIPTextModel(cfg.clip), AutoencoderKL(cfg.vae)
    key = jax.random.PRNGKey(0)
    s = cfg.latent_size
    lat = jnp.zeros((1, s, s, cfg.unet.in_channels), jnp.float32)
    ctx = jnp.zeros((1, 77, cfg.unet.cross_attention_dim), jnp.float32)
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = {
        "unet": jax.eval_shape(unet.init, key, lat, jnp.int32(0), ctx)["params"],
        "text_encoder": jax.eval_shape(clip.init, key, jnp.zeros((1, 77), jnp.int32))["params"],
        # both directions, as create() does, so the tree is complete
        "vae": jax.eval_shape(
            lambda k, z, x: vae.init(k, z, x, method=lambda m, z, x: (m.decode(z), m.encode(x))), key, lat, img
        )["params"],
    }
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape), jnp.float32), shapes
    )
    return StableDiffusion(cfg, unet, clip, vae, load_tokenizer(None), params)
