"""The port's latent updates against the JAX package's, in bfloat16.

The main path runs in bf16, so each refinement step's rounding matters.
numpy-seeded bf16 [1, 64, 64, 4] latents, gradients and velocities of
about 1e-3 go through jitted ``guided_attention_tpu.pipeline``'s
``plain_update`` and ``sgd_momentum_update`` and through the port's, with
``lr`` a float32 scalar as the JAX pipeline passes it (``step_sizes[i]``, a
float32 array; ``* 200`` in deep mode).

Limits: the momentum ``vel2`` bitwise equal; the updated latent equal but
for at most 0.1% of its elements, each off by at most one bf16 ulp. XLA:CPU
may contract ``v - c * x`` into one fused multiply-add, which rounds once
where PyTorch rounds twice; that flips the bf16 rounding of a handful of
elements (0-3 of 16,384 measured), and only that.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import guided_attention_tpu.pipeline as jpipe
import guided_attention_tpu_torch.pipeline as tpipe

SHAPE = (1, 64, 64, 4)
MAX_SHARE = 1e-3


def _bf16_inputs(seed: int):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(SHAPE).astype(np.float32)
    grad = (1e-3 * rng.standard_normal(SHAPE)).astype(np.float32)
    vel = (1e-3 * rng.standard_normal(SHAPE)).astype(np.float32)
    jax_in = [jnp.asarray(a, jnp.bfloat16) for a in (v, grad, vel)]
    # the same bf16 values on both sides
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in jax_in]
    return jax_in, torch_in


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_latent_close(got: torch.Tensor, want) -> None:
    """At most MAX_SHARE of the elements differ, each by one bf16 ulp."""
    g = _bits(got).astype(np.int32)
    w = _bits(want).astype(np.int32)
    differ = g != w
    assert differ.mean() <= MAX_SHARE, f"{differ.mean():.4%} of the latent differs"
    # same sign and at most one step apart in the bf16 encoding
    assert np.all(np.abs(g[differ] - w[differ]) <= 1), "an element differs by more than one bf16 ulp"


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(jpipe.sgd_momentum_update), jax.jit(jpipe.plain_update)


# 14.14 and 20: the default step sizes' range; 7.3: a third value; 2828.0:
# deep mode's step size * 200
LRS = [7.3, 14.14, 20.0, 2828.0]


@pytest.mark.parametrize("lr", LRS)
def test_sgd_momentum_update_matches_jax_bf16(jitted, lr):
    jsgd, _ = jitted
    (jv, jg, jvel), (tv, tg, tvel) = _bf16_inputs(int(lr * 100))
    j_lat, j_vel2 = jsgd(jv, jg, jvel, jnp.float32(lr))
    t_lat, t_vel2 = tpipe.sgd_momentum_update(tv, tg, tvel, float(np.float32(lr)))
    assert t_lat.dtype == t_vel2.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t_vel2), _bits(j_vel2))
    _assert_latent_close(t_lat, j_lat)


@pytest.mark.parametrize("lr", LRS)
def test_plain_update_matches_jax_bf16(jitted, lr):
    _, jplain = jitted
    (jv, jg, _), (tv, tg, _) = _bf16_inputs(1 + int(lr * 100))
    for loss in (0.25, 0.0):  # applied, and skipped at a zero loss
        j_lat = jplain(jv, jg, jnp.float32(lr), jnp.float32(loss))
        t_lat = tpipe.plain_update(tv, tg, float(np.float32(lr)), torch.tensor(loss))
        assert t_lat.dtype == torch.bfloat16
        _assert_latent_close(t_lat, j_lat)
        if loss == 0.0:
            np.testing.assert_array_equal(_bits(t_lat), _bits(tv))


def test_sgd_momentum_update_over_steps_bf16(jitted):
    """Five refinement steps carried on each side from the same start: the
    momentum stays bitwise equal and the latent within the limit."""
    jsgd, _ = jitted
    (jv, jg, jvel), (tv, tg, tvel) = _bf16_inputs(5)
    jvel, tvel = jnp.zeros_like(jvel), torch.zeros_like(tvel)
    rng = np.random.default_rng(6)
    for _ in range(5):
        g = (1e-3 * rng.standard_normal(SHAPE)).astype(np.float32)
        jg = jnp.asarray(g, jnp.bfloat16)
        tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(torch.bfloat16)
        jv, jvel = jsgd(jv, jg, jvel, jnp.float32(14.14))
        tv, tvel = tpipe.sgd_momentum_update(tv, tg, tvel, float(np.float32(14.14)))
        np.testing.assert_array_equal(_bits(tvel), _bits(jvel))
        # carry the JAX latent on both sides, so that each step's rounding
        # is checked alone
        _assert_latent_close(tv, jv)
        tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
