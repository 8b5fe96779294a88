"""The port's UNet, CLIP text encoder and VAE decoder against the JAX
package's at the micro config in float32, with the same weights
(``params_from_jax``) and the same numpy inputs.

Tolerance: 1e-4 absolute on outputs of size O(1)-O(10) (float32 through a
dozen layers, sums in another order); maps 1e-5 (probabilities).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch


from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.guidance.losses import compute_loss, compute_token_stats
from guided_attention_tpu_torch.guidance.spec import build_guidance_spec
from guided_attention_tpu_torch.annotation import parse_prompt
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.pipeline import aggregate_cross_maps

from torch_port_helpers import jax_micro_bundle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jsd = jax_micro_bundle()
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return jsd, tsd


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "lat": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "ctx": rng.standard_normal((1, 77, 64)).astype(np.float32),
        "deep": rng.standard_normal((1, 2, 2, 64)).astype(np.float32),
    }


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_params_from_jax_fills_every_key(pair):
    jsd, tsd = pair
    from guided_attention_tpu_torch.models.convert import params_from_jax

    for name, mod in (("unet", tsd.unet), ("text_encoder", tsd.text_encoder), ("vae", tsd.vae)):
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jsd.params[name]), mod, name)
        assert set(sd) == set(mod.state_dict())
    # a Linear and a Conv land transposed
    k = np.asarray(jsd.params["unet"]["conv_in"]["kernel"])  # HWIO
    np.testing.assert_array_equal(tsd.unet.conv_in.weight.numpy(), k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("case", ["plain", "capture", "deep_inject", "pww"])
def test_unet_matches_jax(pair, inputs, case):
    jsd, tsd = pair
    capture = frozenset()
    kw_j, kw_t = {}, {}
    if case in ("capture", "pww"):
        capture = frozenset({("cross", 16), ("self", 8), ("cross_perhead", 4)})
    if case == "deep_inject":
        kw_j["deep_inject"] = jnp.asarray(inputs["deep"])
        kw_t["deep_inject"] = torch.from_numpy(inputs["deep"])
    if case == "pww":
        rng = np.random.default_rng(1)
        masks = {r: (rng.random((r * r, 77)) > 0.8).astype(np.float32) for r in (2, 4, 8, 16)}
        kw_j.update(pww={r: jnp.asarray(m) for r, m in masks.items()}, pww_gate=jnp.asarray(0.3))
        kw_t.update(pww={r: torch.from_numpy(m) for r, m in masks.items()}, pww_gate=torch.tensor(0.3))
    je, jaux = jsd.unet.apply(
        {"params": jsd.params["unet"]}, jnp.asarray(inputs["lat"]), 500, jnp.asarray(inputs["ctx"]),
        capture=capture, **kw_j,
    )
    with torch.no_grad():
        te, taux = tsd.unet(torch.from_numpy(inputs["lat"]), 500, torch.from_numpy(inputs["ctx"]), capture=capture, **kw_t)
    _close(te, je)
    _close(taux["deep"], jaux["deep"])
    for key, jl in jaux["maps"].items():
        tl = taux["maps"][key]
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == tuple(b.shape), key
            _close(a, b, 1e-5)


def test_truncated_eval_forward_equals_full(pair, inputs):
    """The guidance eval's forward stops after the last captured layer; its
    maps, loss and latent gradient equal those of the full forward (capture
    at 8x8: up_blocks_3 and the output convs are skipped)."""
    _jsd, tsd = pair
    prompt, anns, _ = parse_prompt("a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]")
    hp = HyperParams()
    spec = build_guidance_spec(tsd.tokenizer, prompt, anns, hp, attention_res=8, device="cpu")
    ctx = torch.from_numpy(inputs["ctx"])
    capture = frozenset({("cross", 8)})

    def loss_and_grad(truncate):
        lat = torch.from_numpy(inputs["lat"]).requires_grad_(True)
        eps, aux = tsd.unet(lat, 500, ctx, capture=capture, truncate=truncate)
        assert (eps is None) == truncate
        stats = compute_token_stats(aggregate_cross_maps(aux["maps"], 8)[0], spec, hp)
        total = compute_loss(stats, spec, hp)[0]
        (g,) = torch.autograd.grad(total, lat)
        return total.detach(), g, len(aux["maps"]["up_cross"])

    l_full, g_full, n_full = loss_and_grad(False)
    l_tr, g_tr, n_tr = loss_and_grad(True)
    assert n_full == n_tr == 2  # up_blocks_2's two 8x8 layers at micro
    torch.testing.assert_close(l_tr, l_full, atol=0, rtol=0)
    torch.testing.assert_close(g_tr, g_full, atol=0, rtol=0)
    assert float(g_full.abs().max()) > 0


def test_truncate_without_capture_stops_at_deep(pair, inputs):
    _jsd, tsd = pair
    with torch.no_grad():
        eps, aux = tsd.unet(torch.from_numpy(inputs["lat"]), 500, torch.from_numpy(inputs["ctx"]), truncate=True)
        _e, full = tsd.unet(torch.from_numpy(inputs["lat"]), 500, torch.from_numpy(inputs["ctx"]))
    assert eps is None
    torch.testing.assert_close(aux["deep"], full["deep"], atol=0, rtol=0)


def test_clip_matches_jax(pair):
    jsd, tsd = pair
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 49408, size=(2, 77))
    jh = jsd.text_encoder.apply({"params": jsd.params["text_encoder"]}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        th = tsd.text_encoder(torch.from_numpy(ids))
    _close(th, jh)
    # the bundle's prompt encoding agrees too (same SimpleTokenizer)
    je = jsd.encode_prompt("a robot and a vase")
    te = tsd.encode_prompt("a robot and a vase")
    _close(te, je)


def test_vae_decode_matches_jax(pair, inputs):
    jsd, tsd = pair
    ji = jsd.decode_latents(jnp.asarray(inputs["lat"]))
    ti = tsd.decode_latents(torch.from_numpy(inputs["lat"]))
    assert tuple(ti.shape) == (1, 128, 128, 3)
    _close(ti, ji)
    ju = np.asarray(jsd.decode_latents_u8(jnp.asarray(inputs["lat"]))).astype(int)
    tu = tsd.decode_latents_u8(torch.from_numpy(inputs["lat"])).numpy().astype(int)
    assert np.abs(ju - tu).max() <= 1


def test_random_init_is_flax_like_and_seeded():
    a = TSD.create("micro", torch.float32, device="cpu", seed=3)
    b = TSD.create("micro", torch.float32, device="cpu", seed=3)
    c = TSD.create("micro", torch.float32, device="cpu", seed=4)
    wa, wb, wc = (m.unet.down_blocks[0].resnets[0].conv1.weight for m in (a, b, c))
    torch.testing.assert_close(wa, wb, atol=0, rtol=0)
    assert not torch.equal(wa, wc)
    # lecun normal: variance 1/fan_in, truncated at 2 std
    fan_in = wa[0].numel()
    assert abs(float(wa.std()) * fan_in**0.5 - 1.0) < 0.1
    assert float(wa.abs().max()) <= 2.0 / 0.87962566103423978 / fan_in**0.5 + 1e-6
    assert float(a.unet.conv_in.bias.abs().max()) == 0.0
    assert not any(p.requires_grad for p in a.unet.parameters())
