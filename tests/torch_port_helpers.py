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


def jax_param_shapes(model: str, dtype=jnp.float32, components=("unet", "text_encoder", "vae"), cfg=None) -> dict:
    """The JAX package's parameter trees of a preset's ``components`` (or of
    the configuration ``cfg``) as ``ShapeDtypeStruct`` leaves: the trees
    ``StableDiffusion.create`` inits, traced by ``jax.eval_shape`` on
    abstract inputs (nothing is compiled or allocated)."""
    cfg = cfg if cfg is not None else get_config(model, dtype)
    spec = jax.ShapeDtypeStruct
    key = spec((2,), jnp.uint32)
    s = cfg.latent_size
    lat = spec((1, s, s, cfg.unet.in_channels), dtype)
    inits = {
        "unet": lambda: jax.eval_shape(UNet2DCondition(cfg.unet).init, key, lat, spec((), jnp.int32),
                                       spec((1, 77, cfg.unet.cross_attention_dim), dtype)),
        "text_encoder": lambda: jax.eval_shape(CLIPTextModel(cfg.clip).init, key, spec((1, 77), jnp.int32)),
        # both directions, as create() does, so the tree is complete
        "vae": lambda: jax.eval_shape(
            lambda k, z, x: AutoencoderKL(cfg.vae).init(k, z, x, method=lambda m, z, x: (m.decode(z), m.encode(x))),
            key, lat, spec((1, 32, 32, 3), dtype)),
    }
    return {c: inits[c]()["params"] for c in components}


def jax_micro_bundle(seed: int = 0, cfg=None) -> StableDiffusion:
    """The JAX package's micro StableDiffusion in float32 (or the
    configuration ``cfg``, a variant of it), random weights; float32
    parameters whatever ``cfg``'s compute dtype."""
    cfg = cfg if cfg is not None else get_config("micro", jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape), jnp.float32),
        jax_param_shapes("micro", cfg=cfg),
    )
    return StableDiffusion(cfg, UNet2DCondition(cfg.unet), CLIPTextModel(cfg.clip), AutoencoderKL(cfg.vae),
                           load_tokenizer(None), params)


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
