"""The slice as a whole: the JAX package's GuidedAttentionPipeline against
the port's, at micro in float32, with the same weights (``params_from_jax``),
the same initial latents and JAX's own re-noise draws handed to the port.

Thresholds of 0.0 are never met (every unscaled loss is > 0), so both
packages take the same branches whatever their rounding: ten refinement
iterations, the final eval, the update gate and three recursions at each
threshold step. Tolerances: the counters match exactly; the losses within
1e-4 absolute and the final latents within 1e-4 of their largest magnitude
(float32 through ~70 guidance evals with a step size of 20); the uint8
images within 1 LSB.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe

from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe

from torch_port_helpers import assert_same_run, jax_draws, jax_micro_bundle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
SEED = 1


@pytest.fixture(scope="module")
def pipes():
    jsd = jax_micro_bundle()
    jp = JPipe(jsd)
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return jp, TPipe(tsd)


@pytest.fixture(scope="module")
def runs(pipes):
    jp, tp = pipes
    lat0, noise = jax_draws(jp, SEED)
    kw = dict(meta_prompt=META, seed=SEED, num_inference_steps=4, thresholds={0: 0.0, 2: 0.0})
    jo = jp(latents=lat0, **kw)
    to = tp(latents=lat0, noise=noise, **kw)
    return jo, to, lat0, noise, kw


def test_whole_slice_matches_jax(runs):
    jo, to, _lat0, _noise, _kw = runs
    d = to.diagnostics
    # the branches the thresholds force
    np.testing.assert_array_equal(d.refine_iters, [10, 0, 10, 0])
    np.testing.assert_array_equal(d.recursions, [3, 1, 3, 1])
    np.testing.assert_array_equal(d.n_evals, [36, 0, 36, 0])
    assert_same_run(jo, to)
    ju = np.round(np.asarray(jo.images) * 255).astype(int)
    assert to.images_u8.dtype == np.uint8 and to.images_u8.shape == (1, 128, 128, 3)
    assert np.abs(ju - to.images_u8.astype(int)).max() <= 1


def test_whole_slice_diagnostics_match_jax(runs):
    jo, to, *_ = runs
    jd, td = jo.diagnostics, to.diagnostics
    for f in ("group_unscaled", "per_token_unscaled", "eval_unscaled", "col", "row", "max_attn", "latent_mean"):
        a, b = getattr(td, f), np.asarray(getattr(jd, f), np.float32)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, float(np.abs(b).max())), rtol=0, err_msg=f)
    np.testing.assert_array_equal(td.eval_mask, np.asarray(jd.eval_mask))
    np.testing.assert_allclose(td.maps.astype(np.float32), np.asarray(jd.maps, np.float32), atol=2e-3, rtol=0)


def test_flash_route_equals_plain_route(pipes, runs):
    """use_flash_attention=True with flash_min_seq lowered to 256 sends the
    16x16 self-attention through K1/K2 and the captured cross-attention
    through K3 (their plain versions on the CPU); the run equals the
    plain-matmul route."""
    _jp, tp = pipes
    jo, to, lat0, noise, kw = runs
    unet = tp.sd.unet
    cfg = unet.config
    unet.config = dataclasses.replace(cfg, use_flash_attention=True, flash_min_seq=256)
    try:
        fo = tp(latents=lat0, noise=noise, **kw)
    finally:
        unet.config = cfg
    assert_same_run(to, fo, lat_rtol=1e-5)


def test_standard_sd_with_eta_matches_jax(pipes):
    """run_standard_sd with eta > 0: JAX's eta draws handed to the port."""
    jp, tp = pipes
    lat0, noise = jax_draws(jp, 3)
    kw = dict(meta_prompt=META, seed=3, num_inference_steps=3, run_standard_sd=True, eta=0.5, capture_diagnostics=False)
    jo = jp(latents=lat0, **kw)
    to = tp(latents=lat0, noise=noise, **kw)
    assert_same_run(jo, to)


def test_deep_mode_with_optimizer_matches_jax(pipes):
    """optimize_deep_latent + use_optimizer: the bottleneck features are the
    optimization variable, driven by the SGD-momentum refinement."""
    jp, tp = pipes
    lat0, noise = jax_draws(jp, 5)
    kw = dict(meta_prompt=META, seed=5, num_inference_steps=2, capture_diagnostics=False)
    jo = jp(latents=lat0, hp=JHP(optimize_deep_latent=True, use_optimizer=True, thresholds={0: 0.0}, recurse_steps=1), **kw)
    to = tp(latents=lat0, noise=noise, hp=THP(optimize_deep_latent=True, use_optimizer=True, thresholds={0: 0.0}, recurse_steps=1), **kw)
    np.testing.assert_array_equal(to.diagnostics.refine_iters, [10, 0])
    assert_same_run(jo, to)


def test_seeded_runs_are_deterministic_and_seed_sensitive(pipes):
    _jp, tp = pipes
    kw = dict(meta_prompt=META, num_inference_steps=2, thresholds={0: 0.5}, capture_diagnostics=False)
    a = tp(seed=7, **kw)
    b = tp(seed=7, **kw)
    c = tp(seed=8, **kw)
    np.testing.assert_array_equal(a.latents, b.latents)
    assert not np.array_equal(a.latents, c.latents)
    assert a.diagnostics.maps.shape == (2, 1, 1, 1)  # diag level 0 placeholders
    with pytest.raises(ValueError, match="num_inference_steps"):
        tp(meta_prompt=META, num_inference_steps=0)
    with pytest.raises(ValueError, match="attention_res"):
        tp(meta_prompt=META, num_inference_steps=2, attention_res=32)


def test_remat_and_eval_capture_options(pipes, runs):
    """remat_guidance_eval recomputes the eval forward in its backward (same
    math, same trajectory); capture_eval_maps / capture_eval_latents fill
    one slot per eval, as the JAX package's StepDiag does."""
    _jp, tp = pipes
    _jo, to, lat0, noise, kw = runs
    out = tp(latents=lat0, noise=noise, remat_guidance_eval=True, capture_eval_maps=True, capture_eval_latents=True, **kw)
    assert_same_run(to, out, lat_rtol=1e-5)
    d = out.diagnostics
    assert d.eval_maps.shape == (4, 12, 16, 16, 77)
    assert d.eval_latents.shape == (4, 12, 16, 16, 4)
    slots = np.nonzero(d.eval_mask[0])[0]
    assert list(slots) == list(range(12))  # eval0, 10 refinements, final
    assert (d.eval_maps[0, slots].astype(np.float32).max(axis=(1, 2, 3)) > 0).all()
    assert not np.array_equal(d.eval_latents[0, 0], d.eval_latents[0, 11])
    assert not d.eval_mask[1].any()
