"""The port's guidance engine and DDIM scheduler against the JAX package's:
spec building, smoothing, token stats, losses and their gradients w.r.t.
the maps, meets_threshold, ToLeftOf, ddim_step and renoise with injected
noise. float32 throughout; tolerances 1e-6 on probabilities and 1e-5 on
losses and gradients (sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from guided_attention_tpu import annotation as jann
from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.guidance import custom as jcustom
from guided_attention_tpu.guidance import losses as jl
from guided_attention_tpu.guidance.smoothing import smooth_maps as jsmooth
from guided_attention_tpu.guidance.spec import build_guidance_spec as jbuild
from guided_attention_tpu.models.tokenizer import SimpleTokenizer as JTok
from guided_attention_tpu.schedulers import ddim as jddim

from guided_attention_tpu_torch import annotation as tann
from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.guidance import custom as tcustom
from guided_attention_tpu_torch.guidance import losses as tl
from guided_attention_tpu_torch.guidance.smoothing import smooth_maps as tsmooth
from guided_attention_tpu_torch.guidance.spec import build_guidance_spec as tbuild
from guided_attention_tpu_torch.models.tokenizer import SimpleTokenizer as TTok
from guided_attention_tpu_torch.schedulers import ddim as tddim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [
    "a [robot:.6,.3,.4,.55] and a [blue vase:0,.3,.4,.55]",
    "a [cat:.2,.4] next to a [dog:.7,.5,.2,.3] and a tree",
    "a cat and a vase [CustomLoss:toLeftOf (cat,vase)]",
]
HP_CASES = {
    "default": {},
    "strict_kw_pww": dict(strict=True, keyword_max_loss_scale=0.5, paint_with_words_stop=3),
}


def _specs(meta, hp_kw, res=16):
    jp, ja, jc = jann.parse_prompt(meta, jcustom.default_registry().as_dict())
    tp, ta, tc = tann.parse_prompt(meta, tcustom.default_registry().as_dict())
    assert jp == tp
    js = jbuild(JTok(), jp, ja, JHP(**hp_kw), jc, attention_res=res)
    ts = tbuild(TTok(), tp, ta, THP(**hp_kw), tc, attention_res=res, device="cpu")
    return js, ts


@pytest.mark.parametrize("hp_name", list(HP_CASES))
@pytest.mark.parametrize("meta", PROMPTS)
def test_build_guidance_spec_matches_jax(meta, hp_name):
    js, ts = _specs(meta, HP_CASES[hp_name])
    for f in ("token_mask", "ann_type", "center_xy", "subprompt_id", "valid_text", "inside_mask", "w_in", "w_out", "at_most"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert set(ts.pww_masks) == set(js.pww_masks)
    for r in js.pww_masks:
        np.testing.assert_array_equal(ts.pww_masks[r].numpy(), np.asarray(js.pww_masks[r]))
    for f in ("n_groups", "custom_group", "attention_res", "words", "subprompts"):
        assert getattr(ts, f) == getattr(js, f), f
    assert len(ts.custom_losses) == len(js.custom_losses)
    for (tn, tobj, _), (jn, jobj, _) in zip(ts.custom_losses, js.custom_losses):
        assert tn == jn and tobj.static_state() == jobj.static_state()


def test_smoothing_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.random((5, 16, 16)).astype(np.float32)
    for ks, sigma in ((3, 0.5), (5, 1.0)):
        np.testing.assert_allclose(tsmooth(torch.from_numpy(m), ks, sigma).numpy(), np.asarray(jsmooth(jnp.asarray(m), ks, sigma)), atol=1e-6, rtol=0)


def _maps(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((16, 16, 77)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("avg_within", [False, True])
@pytest.mark.parametrize("hp_name", list(HP_CASES))
@pytest.mark.parametrize("meta", PROMPTS)
def test_token_stats_losses_and_grads_match_jax(meta, hp_name, avg_within):
    js, ts = _specs(meta, HP_CASES[hp_name])
    jhp, thp = JHP(**HP_CASES[hp_name]), THP(**HP_CASES[hp_name])
    maps = _maps(1)

    def jfn(m):
        st = jl.compute_token_stats(m, js, jhp)
        total, gs, gu, valid = jl.compute_loss(st, js, jhp, avg_within)
        _s, un = jl.per_token_losses(st, js, jhp)
        return total, (st, gs, gu, valid, un)

    (jtotal, (jst, jgs, jgu, jvalid, jun)), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(maps))

    tm = torch.from_numpy(maps).requires_grad_(True)
    tst = tl.compute_token_stats(tm, ts, thp)
    ttotal, tgs, tgu, tvalid = tl.compute_loss(tst, ts, thp, avg_within)
    _s, tun = tl.per_token_losses(tst, ts, thp)
    (tgrad,) = torch.autograd.grad(ttotal, tm)

    for f in ("probs", "smoothed", "max_attn", "col", "row", "inside_loss", "outside_loss", "custom_loss"):
        np.testing.assert_allclose(getattr(tst, f).detach().numpy(), np.asarray(getattr(jst, f)), atol=1e-5, rtol=0, err_msg=f)
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgs.detach().numpy(), np.asarray(jgs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgu.detach().numpy(), np.asarray(jgu), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tun.detach().numpy(), np.asarray(jun), atol=1e-5, rtol=0)
    assert np.isfinite(tgrad.numpy()).all()
    # the x100 re-softmax makes the map gradient a difference of large terms:
    # its float32 rounding scales with the gradient's largest entry
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jg, atol=1e-5 * max(1.0, float(np.abs(jg).max())), rtol=0)


def test_meets_threshold_matches_jax_and_last_value_rule():
    gu = np.asarray([0.3, 0.9, 5.0], np.float32)
    for valid in ([True, True, False], [True, True, True], [False, False, False]):
        v = np.asarray(valid)
        for thr in (0.2, 0.3, 0.95, 10.0):
            j = bool(jl.meets_threshold(jnp.asarray(gu), jnp.asarray(v), thr))
            t = bool(tl.meets_threshold(torch.from_numpy(gu), torch.from_numpy(v), thr))
            assert j == t, (valid, thr)
    # the update gate reads the LAST threshold of the run's dict
    # (meets_threshold(-1), pipeline:1083), as the runner sets it up
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline, PrepareOptions
    from guided_attention_tpu_torch.models.bundle import StableDiffusion

    pipe = GuidedAttentionPipeline(StableDiffusion.create("micro", torch.float32, device="cpu"))
    st = pipe._prepare(PrepareOptions(meta_prompt=PROMPTS[0], num_inference_steps=4, thresholds={0: 0.1, 2: 0.7}))[4]
    assert st.last_threshold == pytest.approx(0.7)


def test_ddim_schedule_step_and_renoise_match_jax():
    S = 7
    js = jddim.make_ddim_schedule(S)
    ts = tddim.make_ddim_schedule(S, device="cpu")
    for f in ("timesteps", "alpha_prod", "alpha_prod_prev", "sigmas", "renoise_beta"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-7, err_msg=f)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))  # JAX's own draw, handed to the port
    for i in (0, 3, S - 1):
        jp, jx0 = jddim.ddim_step(js, i, jnp.asarray(eps), jnp.asarray(x))
        tp, tx0 = tddim.ddim_step(ts, i, torch.from_numpy(eps), torch.from_numpy(x))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-6)
        jp, _ = jddim.ddim_step(js, i, jnp.asarray(eps), jnp.asarray(x), eta=0.7, key=key)
        tp, _ = tddim.ddim_step(ts, i, torch.from_numpy(eps), torch.from_numpy(x), eta=0.7, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-6)
        jr = jddim.renoise(js, i, jnp.asarray(x), key)
        tr = tddim.renoise(ts, i, torch.from_numpy(x), torch.from_numpy(noise))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="noise"):
        tddim.ddim_step(ts, 0, torch.from_numpy(eps), torch.from_numpy(x), eta=0.5)


def test_to_left_of_matches_jax():
    meta = PROMPTS[2]
    js, ts = _specs(meta, {})
    maps = _maps(4)
    (_, jobj, jargs), (_, tobj, targs) = js.custom_losses[0], ts.custom_losses[0]
    jv, jg = jax.value_and_grad(lambda m: jobj.calc_loss(m, js, jargs))(jnp.asarray(maps))
    tm = torch.from_numpy(maps).requires_grad_(True)
    tv = tobj.calc_loss(tm, ts, targs)
    (tg,) = torch.autograd.grad(tv, tm)
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)


def test_hyperparams_and_annotation_copies_agree():
    assert dataclasses.asdict(THP()) == dataclasses.asdict(JHP())
    meta = "a [fox:.1,.2] and [a big rat:.5,.4,.2,.2] runs"
    jp, ja, _ = jann.parse_prompt(meta)
    tp, ta, _ = tann.parse_prompt(meta)
    def flat(anns):
        return [(a.subprompt, int(a.kind), dataclasses.astuple(a.target) if dataclasses.is_dataclass(a.target) else a.target) for a in anns]

    assert jp == tp and flat(ja) == flat(ta)
    with pytest.raises(ValueError, match="unbalanced"):
        tann.parse_prompt("a [fox:.1,.2")


def test_tokenizer_loader_raises_for_a_bad_path(tmp_path):
    """Given a model path, the port's loader raises when no CLIP tokenizer
    loads from it, where the JAX loader falls back to SimpleTokenizer."""
    from guided_attention_tpu_torch.models.tokenizer import load_tokenizer, pad_ids

    pytest.importorskip("transformers")
    with pytest.raises(RuntimeError, match="no CLIP tokenizer"):
        load_tokenizer(str(tmp_path))
    tok = load_tokenizer(None)
    assert pad_ids(tok, "a robot")[:1] == [49406] and len(pad_ids(tok, "a robot")) == 77
