"""Shared by the port's parity tests: the JAX package's micro bundle with
parameters drawn by numpy from a seed; JAX's initial latents and re-noise
draws for a seed (``jax_draws``), to hand to the port; and the contract two
runs are held to (``assert_same_run``).

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
import torch

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


def jax_draws(jp, seed):
    """JAX's initial latents and a port noise source replaying its draws
    (pipeline.py:586-606: fold_in(fold_in(key, i), r), eta stream 104729)."""
    lat0, key_run = jp._derive_jit(jnp.uint32(seed))
    lat0 = np.array(lat0)

    def noise(kind, i, r):
        k = jax.random.fold_in(key_run, i)
        if r is not None:
            k = jax.random.fold_in(k, r)
        if kind == "eta":
            k = jax.random.fold_in(k, 104729)
        return torch.from_numpy(np.array(jax.random.normal(k, lat0.shape, jnp.float32)))

    return lat0, noise


COUNTERS = ("n_evals", "refine_iters", "recursions", "did_update")


def assert_same_run(jo, to, lat_rtol=1e-4):
    """Counters bit for bit, the losses within 1e-4 absolute, the final
    latents within ``lat_rtol`` of their largest magnitude."""
    jd, td = jo.diagnostics, to.diagnostics
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(td, f), np.asarray(getattr(jd, f)), err_msg=f)
    np.testing.assert_allclose(td.total_loss, np.asarray(jd.total_loss), atol=1e-4, rtol=0)
    jl = np.asarray(jo.latents, np.float32)
    np.testing.assert_allclose(to.latents, jl, atol=lat_rtol * float(np.abs(jl).max()), rtol=0)
