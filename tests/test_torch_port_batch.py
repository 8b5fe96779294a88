"""Batched generation: the port's ``dispatch_batch`` / ``generate_batch``
against the JAX package, at micro in float32, with the same weights
(``params_from_jax``) and, for every sample, JAX's own initial latents and
re-noise draws for its seed (``jax_draws``).

The JAX package runs a batch as ``vmap`` of its one-sample loop, so sample b
of a batch is the one-sample run of seed b with prompt b; the port's batch
is held to the same contract against JAX's one-sample runs, under
``assert_same_run``'s tolerances (counters bit for bit, the losses within
1e-4 absolute, the final latents within 1e-4 of their largest magnitude).

The guided case against JAX runs with paint-with-words on: its score max is
the one place where a batch could couple its samples, and the case covers
everything else a plain guided batch runs (two prompts with other boxes,
refinement, recursion, the update gate). Each JAX guided program costs
about 25-30 s of XLA:CPU compile, so the file runs one; the batched loop
without paint-with-words is held to the port's own one-sample runs (deep
mode) and to JAX's batch (standard SD).

The threshold parts the two samples: at step 0 the large box's loss lies
under it at the first eval, so that sample neither refines nor recurses,
while the small box's stays above it through every refinement iteration
and both recursions. The test names the smallest distance between the
threshold and a loss that decided a branch, so that a decision that flips
between the packages reads as a margin and not as a wrong counter.
"""
import numpy as np
import pytest
import jax
import torch

from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe

from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.guidance.spec import spec_row, stack_specs
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


BIG, SMALL = "a [dog:0,0,1,1] x", "a [dog:.1,.1,.3,.3] x"  # one group each
OTHER = "a [cat:.6,.6,.3,.3] y"
SEEDS = (1, 2)
STEPS = 3
PWW_STOP = 2
THRESHOLD = 0.5  # step 0: the large box reads 0.204 at its first eval, the small box 0.898-0.986


@pytest.fixture(scope="module")
def pipes():
    jsd = jax_micro_bundle()
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return JPipe(jsd), TPipe(tsd)


@pytest.fixture(scope="module")
def draws(pipes):
    jp, _tp = pipes
    return [jax_draws(jp, s) for s in SEEDS]


def _hp(cls):
    return cls(paint_with_words_stop=PWW_STOP, thresholds={0: THRESHOLD}, recurse_steps=2)


def _batch(tp, draws, prompts, steps=STEPS, **kw):
    lat = np.concatenate([d[0] for d in draws])
    return tp.generate_batch(list(SEEDS), meta_prompts=list(prompts), latents=lat, noise=[d[1] for d in draws],
                             decode=False, num_inference_steps=steps, **kw)


def _margin(out, threshold: float) -> float:
    """Smallest |loss - threshold| over the step-0 evals (one group: its
    loss is the sum of its tokens' unscaled losses)."""
    d = out.diagnostics
    losses = np.asarray(d.eval_unscaled, np.float32)[0].sum(axis=-1)[np.asarray(d.eval_mask)[0]]
    return float(np.abs(losses - threshold).min())


@pytest.fixture(scope="module")
def guided(pipes, draws):
    """(JAX one-sample runs, the port's batch) of BIG and SMALL."""
    jp, tp = pipes
    singles = [jp(meta_prompt=p, seed=s, latents=d[0], decode=False, num_inference_steps=STEPS, hp=_hp(JHP))
               for p, s, d in zip((BIG, SMALL), SEEDS, draws)]
    return singles, _batch(tp, draws, (BIG, SMALL), hp=_hp(THP))


def test_guided_batch_matches_jax_singles(guided):
    """(a, b) Every sample of a guided multi-prompt batch with
    paint-with-words is the JAX one-sample run of its seed and prompt."""
    singles, batch = guided
    margins = [_margin(o, THRESHOLD) for o in singles]
    for jo, to in zip(singles, batch):
        try:
            assert_same_run(jo, to)
        except AssertionError as e:
            raise AssertionError(f"threshold margins {margins}") from e
    big, small = (o.diagnostics for o in batch)
    assert (big.refine_iters[0], big.recursions[0], big.n_evals[0]) == (0, 1, 1)
    assert (small.refine_iters[0], small.recursions[0], small.n_evals[0]) == (10, 2, 24)
    assert [o.prompt for o in batch] == ["a dog x"] * 2
    assert batch[0].annotations[0].target != batch[1].annotations[0].target


def test_guided_batch_diagnostics_match_jax(guided):
    """Per-sample StepDiag fields of the batch equal the one-sample runs'."""
    singles, batch = guided
    for jo, to in zip(singles, batch):
        jd, td = jo.diagnostics, to.diagnostics
        for f in ("group_unscaled", "per_token_unscaled", "eval_unscaled", "col", "row", "max_attn", "latent_mean"):
            a, b = getattr(td, f), np.asarray(getattr(jd, f), np.float32)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(a, b, atol=1e-4 * max(1.0, float(np.abs(b).max())), rtol=0, err_msg=f)
        np.testing.assert_array_equal(td.eval_mask, np.asarray(jd.eval_mask))


def test_sample_does_not_move_with_another_samples_prompt(pipes, draws, guided):
    """(c) With paint-with-words on (whose score max would couple the
    samples if it were taken over the whole batch), sample 0 is unchanged
    within 1e-5 of its largest magnitude when sample 1's prompt changes."""
    _jp, tp = pipes
    _singles, batch = guided
    other = _batch(tp, draws, (BIG, OTHER), hp=_hp(THP))
    ref = batch[0].latents
    np.testing.assert_allclose(other[0].latents, ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)
    assert not np.allclose(other[1].latents, batch[1].latents)


def test_standard_sd_batch_matches_jax_batch(pipes, draws):
    """(d) Multi-prompt standard SD, two steps, against JAX's own
    ``generate_batch`` (vmapped over the batch) within 1e-4."""
    jp, tp = pipes
    kw = dict(num_inference_steps=2, run_standard_sd=True, capture_diagnostics=False, decode=False)
    jouts = jp.generate_batch(list(SEEDS), meta_prompts=[BIG, OTHER], **kw)
    touts = tp.generate_batch(list(SEEDS), meta_prompts=[BIG, OTHER], latents=np.concatenate([d[0] for d in draws]),
                              noise=[d[1] for d in draws], **kw)
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(to.latents, np.asarray(jo.latents), atol=1e-4, rtol=0)
    assert not np.array_equal(touts[0].latents, touts[1].latents)


def test_deep_mode_batch_matches_port_singles(pipes, draws):
    """(e) Deep mode with the SGD-momentum optimizer: the bottleneck
    features are the variable, and the CFG pass injects them only for the
    sample that refined (a per-sample gate inside one forward)."""
    _jp, tp = pipes
    hp = THP(optimize_deep_latent=True, use_optimizer=True, thresholds={0: 1.0}, recurse_steps=1)
    batch = _batch(tp, draws, (BIG, SMALL), steps=2, hp=hp)
    singles = [tp(meta_prompt=p, seed=s, latents=d[0], noise=d[1], decode=False, num_inference_steps=2, hp=hp)
               for p, s, d in zip((BIG, SMALL), SEEDS, draws)]
    np.testing.assert_array_equal([o.diagnostics.refine_iters[0] for o in batch], [0, 10])
    for so, bo in zip(singles, batch):
        assert_same_run(so, bo)


@pytest.mark.parametrize("case", ["both_prompt_kinds", "count_mismatch", "group_structure", "custom_bindings"])
def test_batch_misuse_errors(pipes, case):
    """(f) The JAX package's misuse errors (tests/test_parallel.py), with
    the same types and messages."""
    jp, tp = pipes
    cl = "a [cat:.1,.3,.3,.4] and a [dog:.6,.3,.3,.4] [CustomLoss:toLeftOf ({})]"
    kw = {
        "both_prompt_kinds": dict(seeds=[1], meta_prompt="a dog", meta_prompts=["a dog"]),
        "count_mismatch": dict(seeds=[1, 2], meta_prompts=["a dog"]),
        "group_structure": dict(seeds=[1, 2], meta_prompts=["a [dog:.2,.3] x", "a [dog:.2,.3] and a [cat:.6,.6] x"]),
        "custom_bindings": dict(seeds=[1, 2], meta_prompts=[cl.format("cat,dog"), cl.format("dog,cat")]),
    }[case]
    errors = []
    for pipe in (jp, tp):
        with pytest.raises((TypeError, ValueError)) as info:
            pipe.generate_batch(num_inference_steps=2, decode=False, **kw)
        errors.append((type(info.value), str(info.value)))
    assert errors[1] == errors[0]


def test_stack_specs_round_trip_and_cache(pipes):
    """``stack_specs`` gives every tensor (paint-with-words masks included)
    a batch axis and ``spec_row`` takes each prompt's back; a repeated
    prompt set reuses the cached stack."""
    _jp, tp = pipes
    from guided_attention_tpu_torch.runner import PrepareOptions

    opts = PrepareOptions(hp=_hp(THP))
    specs = [tp._prepare(PrepareOptions(meta_prompt=p, hp=opts.hp))[3] for p in (BIG, SMALL)]
    stacked = stack_specs(specs)
    assert stacked.pww_masks[16].shape == (2, 256, 77) and stacked.inside_mask.shape == (2, 77, 16, 16)
    for b, spec in enumerate(specs):
        row = spec_row(stacked, b)
        for name in ("token_mask", "center_xy", "inside_mask", "w_in", "w_out", "at_most"):
            torch.testing.assert_close(getattr(row, name), getattr(spec, name), rtol=0, atol=0)
        torch.testing.assert_close(row.pww_masks[64], spec.pww_masks[64], rtol=0, atol=0)
    tp._stack_cache.clear()
    prepared = tp._prepare_batch(opts, [5, 6], [BIG, SMALL])
    assert len(tp._stack_cache) == 1
    assert tp._prepare_batch(opts, [7, 8], [BIG, SMALL])[2] is prepared[2]
