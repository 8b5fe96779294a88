"""A diffusers checkpoint directory loads into the port as into the JAX package.

One micro checkpoint is written with ``tests/test_torch_golden.py``'s
synthesizers (real diffusers key names: legacy VAE attention names
``query/key/value/proj_attn/norm``, CLIP's ``position_ids`` buffer): the
UNet as safetensors, the text encoder and the VAE as torch ``.bin``, so
that both readers run. The port loads it with
``StableDiffusion.create(..., checkpoint_dir=)``; the JAX package with its
own ``models/convert.load_component_params`` into the micro bundle's
parameter tree (shapes by ``jax.eval_shape``, as ``torch_port_helpers``
builds it, which skips ``create``'s jitted init). The UNet, the CLIP text
encoder, the VAE decoder and the VAE encoder are then held against each
other in float32 at the parity tests' tolerance, 1e-4 absolute.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from guided_attention_tpu.models.convert import load_component_params as jax_load_component_params
from guided_attention_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL

from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.convert import (
    checkpoint_state_dict,
    load_state_dict_file,
    params_from_jax,
)

from test_torch_golden import make_clip_sd, make_unet_sd, make_vae_sd
from torch_port_helpers import jax_micro_bundle

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp("diffusers_micro")
    sds = {"unet": make_unet_sd(), "text_encoder": make_clip_sd(), "vae": make_vae_sd()}
    for sub in sds:
        (root / sub).mkdir()
    save_file({k: v.contiguous() for k, v in sds["unet"].items()}, str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    torch.save(sds["text_encoder"], root / "text_encoder" / "pytorch_model.bin")
    torch.save(sds["vae"], root / "vae" / "diffusion_pytorch_model.bin")
    return str(root), sds


@pytest.fixture(scope="module")
def pair(ckpt):
    root, _sds = ckpt
    jsd = jax_micro_bundle()
    jsd.params = {name: jax_load_component_params(root, name, jsd.params[name])
                  for name in ("unet", "text_encoder", "vae")}
    tsd = TSD.create("micro", torch.float32, device="cpu", checkpoint_dir=root)
    return jsd, tsd


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_both_readers_and_every_key(ckpt, pair):
    """The safetensors and .bin readers return the written tensors; the
    port's modules hold exactly the JAX package's converted parameters."""
    root, sds = ckpt
    _jsd, tsd = pair
    for sub in ("unet", "vae"):  # safetensors, .bin
        got = load_state_dict_file(f"{root}/{sub}")
        assert set(got) == set(sds[sub])
        assert all(torch.equal(got[k], sds[sub][k]) for k in got)
    jsd, _ = pair
    for name, module in (("unet", tsd.unet), ("text_encoder", tsd.text_encoder), ("vae", tsd.vae)):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jsd.params[name]), module, name)
        have = module.state_dict()
        assert set(want) == set(have)
        for k in have:
            torch.testing.assert_close(have[k], want[k], atol=0, rtol=0, msg=k)
    # the legacy VAE attention names landed on the port's
    np.testing.assert_array_equal(
        tsd.vae.encoder.mid_block.attentions[0].to_out[0].weight.numpy(),
        sds["vae"]["encoder.mid_block.attentions.0.proj_attn.weight"].numpy(),
    )


def test_unet_matches_jax(pair):
    jsd, tsd = pair
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 64)).astype(np.float32)
    je, _ = jsd.unet.apply({"params": jsd.params["unet"]}, jnp.asarray(lat), 501, jnp.asarray(ctx))
    with torch.no_grad():
        te, _ = tsd.unet(torch.from_numpy(lat), 501, torch.from_numpy(ctx))
    _close(te, je)


def test_clip_matches_jax(pair):
    jsd, tsd = pair
    ids = np.random.default_rng(1).integers(0, 49408, size=(2, 77))
    jh = jsd.text_encoder.apply({"params": jsd.params["text_encoder"]}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        th = tsd.text_encoder(torch.from_numpy(ids))
    _close(th, jh)


def test_vae_decoder_matches_jax(pair):
    jsd, tsd = pair
    z = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(np.float32)
    jd = jsd.vae.apply({"params": jsd.params["vae"]}, jnp.asarray(z), method=JaxAutoencoderKL.decode)
    with torch.no_grad():
        td = tsd.vae.decode(torch.from_numpy(z))
    assert tuple(td.shape) == (1, 64, 64, 3)
    _close(td, jd)


def test_vae_encoder_matches_jax(pair):
    jsd, tsd = pair
    x = np.random.default_rng(3).standard_normal((1, 64, 64, 3)).astype(np.float32)
    jm, jl = jsd.vae.apply({"params": jsd.params["vae"]}, jnp.asarray(x), method=JaxAutoencoderKL.encode)
    with torch.no_grad():
        tm, tl = tsd.vae.encode(torch.from_numpy(x))
    assert tuple(tm.shape) == tuple(tl.shape) == (1, 8, 8, 4)
    _close(tm, jm)
    _close(tl, jl)


def test_checkpoint_mismatch_raises(ckpt, pair):
    """A checkpoint missing a module key, or holding a key no module has,
    is refused, not half loaded."""
    _root, sds = ckpt
    _jsd, tsd = pair
    sd = dict(sds["vae"])
    del sd["decoder.conv_in.bias"]
    with pytest.raises(ValueError, match="missing"):
        checkpoint_state_dict(sd, tsd.vae, "vae")
    sd = dict(sds["vae"], **{"decoder.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="decoder.extra.weight"):
        checkpoint_state_dict(sd, tsd.vae, "vae")
