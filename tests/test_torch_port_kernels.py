"""The port's kernel modules against the JAX package's.

The plain versions of K1/K2/K3 (what the wrappers run on CPU tensors, and
what the kernels are held to on the card) against the Pallas kernels run
through the Pallas interpreter, forward and gradients, in float32; and the
port's ``attention()`` against the JAX package's for every route.
Tolerances: float32 with sums in another order, 2e-5 absolute on O(1)
values (5e-5 for gradients through the softmax).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import guided_attention_tpu.ops.flash_attention as jfa
from guided_attention_tpu.ops.attention import attention as jattention

from guided_attention_tpu_torch.ops import flash_attention as tfa
from guided_attention_tpu_torch.ops.attention import attention as tattention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("d", [40, 64])
def test_flash_self_plain_matches_pallas(d):
    B, H, N = 1, 2, 256
    q, k, v, w = _arrays(d, (B, H, N, d), (B, H, N, d), (B, H, N, d), (B, H, N, d))

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, block_q=128, block_q_bwd=64) * w)

    jout = jfa.flash_attention(q, k, v, block_q=128)
    jg = jax.grad(jloss, (0, 1, 2))(q, k, v)

    tq, tk, tv = _t(q, k, v)
    tout = tfa.flash_attention(tq, tk, tv)
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)


@pytest.mark.parametrize("d", [40, 64])
def test_flash_self_fwd_plain_lse_matches_jax(d):
    """K1's second output, the logsumexp K2 reads to recompute P: the natural
    log of the sum of exp(scale * q k^T) per row, held against
    ``jax.nn.logsumexp`` of the JAX side's scaled scores. 1e-5 absolute:
    fp32 on both sides, the sums taken in another order."""
    BH, N = 2, 256
    scale = d**-0.5
    q, k, v = _arrays(100 + d, (BH, N, d), (BH, N, d), (BH, N, d))
    want = jax.nn.logsumexp(jnp.einsum("bqd,bkd->bqk", q, k) * scale, axis=-1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tfa.flash_self_fwd_plain(tq, tk, tv, scale)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (BH, N)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), tfa.flash_self_plain(tq, tk, tv, scale).numpy(), atol=2e-5, rtol=0)


def test_cross_map_plain_matches_pallas():
    B, H, NQ, K, D = 1, 2, 64, 77, 40
    q, k, v, w, wm = _arrays(7, (B, H, NQ, D), (B, H, K, D), (B, H, K, D), (B, H, NQ, D), (B, NQ, K))

    def jloss(q, k, v):
        o, m = jfa.cross_attention_with_map(q, k, v, block_q=64)
        return jnp.sum(o * w) + jnp.sum(m * wm)

    jo, jm = jfa.cross_attention_with_map(q, k, v, block_q=64)
    jg = jax.grad(jloss, (0, 1, 2))(q, k, v)

    tq, tk, tv = _t(q, k, v)
    to, tm = tfa.cross_attention_with_map(tq, tk, tv)
    loss = (to * torch.from_numpy(w)).sum() + (tm * torch.from_numpy(wm)).sum()
    tg = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), atol=2e-6, rtol=0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)


def test_cross_map_backward_function_matches_autograd():
    """The explicit backward of the K3 autograd Function (used on the card)
    equals autograd through the plain version."""
    B, H, NQ, K, D = 1, 2, 32, 77, 16
    q, k, v, w, wm = _arrays(3, (B, H, NQ, D), (B, H, K, D), (B, H, K, D), (B, H, NQ, D), (B, NQ, K))
    tq, tk, tv = _t(q, k, v)
    o, m = tfa.cross_attention_map_plain(tq, tk, tv, D**-0.5)
    ref = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(w), retain_graph=True)
    ref_m = torch.autograd.grad(m, (tq, tk, tv), torch.from_numpy(wm), allow_unused=True, materialize_grads=True)
    got = tfa.cross_attention_map_bwd(tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(w), torch.from_numpy(wm), D**-0.5)
    for g, a, b in zip(got, ref, ref_m):
        np.testing.assert_allclose(g.numpy(), (a + b).numpy(), atol=1e-5, rtol=0)


# (name, kwargs, self-attention?)
ATTN_CASES = [
    ("plain_self", dict(), True),
    ("plain_cross", dict(), False),
    ("capture_cross", dict(capture=True), False),
    ("capture_self", dict(capture=True), True),
    ("capture_perhead", dict(capture_perhead=True), False),
    ("pww", dict(capture=True, pww=True), False),
    ("flash_self", dict(use_flash=True), True),
    ("flash_cross_capture", dict(capture=True, use_flash=True), False),
    ("flash_perhead_falls_back", dict(capture_perhead=True, use_flash=True), False),
    ("flash_pww_falls_back", dict(capture=True, pww=True, use_flash=True), False),
]


@pytest.mark.parametrize("name,kw,is_self", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_matches_jax(name, kw, is_self):
    B, N, C, H = 1, 256, 80, 2
    nk = N if is_self else 77
    q, k, v = _arrays(11, (B, N, C), (B, nk, C), (B, nk, C))
    kw = dict(kw)
    pww = kw.pop("pww", False)
    jkw, tkw = dict(kw), dict(kw)
    if pww:
        mask = np.zeros((N, nk), np.float32)
        mask[:, 3] = 1.0
        jkw.update(pww_mask=jnp.asarray(mask), pww_gate=jnp.asarray(0.7))
        tkw.update(pww_mask=torch.from_numpy(mask), pww_gate=torch.tensor(0.7))
    jo, jm = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, **jkw)
    to, tm = tattention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    assert (tm is None) == (jm is None)
    if jm is not None:
        assert tuple(tm.shape) == tuple(jm.shape)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-6, rtol=0)


def test_attention_routes_to_kernels_and_back():
    """use_flash=True equals the matmul path for the self route and the
    captured-cross route (mirrors tests/test_kernels.py), and pww ignores
    the flag exactly while shifting mass toward the masked token."""
    B, N, C, H = 1, 256, 80, 2
    q, k, v, kc, vc = (torch.from_numpy(a) for a in _arrays(2, (B, N, C), (B, N, C), (B, N, C), (B, 77, C), (B, 77, C)))
    o_e, _ = tattention(q, k, v, H, use_flash=False)
    o_f, _ = tattention(q, k, v, H, use_flash=True)
    torch.testing.assert_close(o_e, o_f, atol=5e-6, rtol=0)
    o_e, m_e = tattention(q, kc, vc, H, capture=True, use_flash=False)
    o_f, m_f = tattention(q, kc, vc, H, capture=True, use_flash=True)
    torch.testing.assert_close(o_e, o_f, atol=5e-6, rtol=0)
    torch.testing.assert_close(m_e, m_f, atol=2e-6, rtol=0)

    mask = torch.zeros(N, 77)
    mask[:, 3] = 1.0
    gate = torch.tensor(0.7)
    o1, m1 = tattention(q, kc, vc, H, capture=True, pww_mask=mask, pww_gate=gate, use_flash=True)
    o2, m2 = tattention(q, kc, vc, H, capture=True, pww_mask=mask, pww_gate=gate, use_flash=False)
    torch.testing.assert_close(o1, o2, atol=0, rtol=0)
    o0, m0 = tattention(q, kc, vc, H, capture=True, use_flash=False)
    assert float(m1[..., 3].mean()) > float(m0[..., 3].mean())
