"""Resumable generation in the port (``runtime/checkpoint.py``,
``generate_resumable``, ``generate_batch_resumable``, the CLI's
``--checkpoint_every``) on the CPU, at micro in float32.

A resumed run must give the uninterrupted run's bits, and those are
``dispatch``'s / ``generate_batch``'s (which the parity tests hold against
the JAX package): latents, image and every ``StepDiag`` field, bitwise.
The runs evaluate guidance, refine and re-noise at steps 0 and 2 (two
recursions each), so a stop after step 2 resumes into step 2's evals and
draws. A stopped run also resumes with a newly built bundle and
pipeline, as a preempted sweep does. The JAX package is used on the host
only: its ``segment_bounds`` and the state files its ``save_state`` writes
(no program is built, no ``jax.jit``).
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from guided_attention_tpu.pipeline import StepDiag as JStepDiag
from guided_attention_tpu.runtime import checkpoint as jckpt

from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.frontends import cli as tcli
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.parallel.mesh import make_mesh
from guided_attention_tpu_torch.pipeline import StepDiag
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe
from guided_attention_tpu_torch.runtime import checkpoint as ckpt

META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
META_2 = "a [robot:0,.1,.45,.5] and a [vase:.55,.4,.4,.5]"
SEED = 3
# thresholds that are not met: ten refinement iterations, the final eval and
# two re-noise recursions at steps 0 and 2; the maps at 4x4 (the cheapest
# eval the micro UNet allows)
KW = dict(meta_prompt=META, num_inference_steps=6, thresholds={0: 1.0, 2: 0.9}, max_iter_to_alter=4,
          hp=HyperParams(recurse_steps=2), attention_res=4)
# cheaper runs for the eta and batch cases: three steps, guidance at step 2
# only, the step a resume after step 2 starts at
KW_STEP2 = dict(KW, num_inference_steps=3, thresholds={2: 0.9})
# no guidance at all, for the identity guard
KW_STANDARD = dict(meta_prompt=META, num_inference_steps=4, run_standard_sd=True)


class Stop(Exception):
    pass


def stop_after(step):
    def on_segment(done, total):
        if done == step:
            raise Stop
    return on_segment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipe():
    return TPipe(TSD.create("micro", torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def ref(pipe):
    return pipe(seed=SEED, **KW)


def assert_same_bits(got, want):
    np.testing.assert_array_equal(got.latents, want.latents)
    np.testing.assert_array_equal(got.images_u8, want.images_u8)
    for f in dataclasses.fields(StepDiag):
        g, w = getattr(got.diagnostics, f.name), getattr(want.diagnostics, f.name)
        assert g.shape == w.shape and g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def state_files(d):
    return sorted(p.name for p in d.glob("genstate_*"))


def test_segment_bounds_match_the_jax_package():
    for total in range(1, 13):
        for every in range(1, 8):
            for start in range(total):
                assert ckpt.segment_bounds(start, total, every) == jckpt.segment_bounds(start, total, every)
    with pytest.raises(ValueError):
        ckpt.segment_bounds(0, 4, 0)


def test_resumable_run_equals_dispatch(pipe, ref, tmp_path):
    assert ref.diagnostics.n_evals[[0, 2]].tolist() == [24, 24] and ref.diagnostics.recursions[[0, 2]].tolist() == [2, 2]
    seen = []
    out = pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(tmp_path),
                                  on_segment=lambda done, total: seen.append((done, total, state_files(tmp_path))),
                                  **KW)
    assert out.resumed_from_step == 0
    assert [s[:2] for s in seen] == [(2, 6), (4, 6), (6, 6)]
    assert len(seen[-1][2]) == 3  # one file per boundary while the run lasts
    assert state_files(tmp_path) == []  # removed when the run completes
    assert_same_bits(out, ref)


@pytest.fixture(scope="module")
def stopped(pipe, tmp_path_factory):
    """A state dir holding the run of ``ref`` stopped after step 2."""
    d = tmp_path_factory.mktemp("stopped")
    with pytest.raises(Stop):
        pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(d), on_segment=stop_after(2), **KW)
    return d


def test_stop_after_step_2_resumes_exactly(pipe, ref, stopped, tmp_path):
    d = shutil.copytree(stopped, tmp_path / "state")
    (name,) = state_files(d)
    assert name.endswith("_0002.msgpack")
    out = pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(d), **KW)
    assert out.resumed_from_step == 2
    assert state_files(d) == []
    assert_same_bits(out, ref)


def test_stop_and_resume_with_a_new_pipeline(ref, stopped, tmp_path):
    """A preempted sweep resumes with a new bundle and pipeline: new
    generators, no prepare cache or loop state of the stopped call, only
    the state file."""
    d = shutil.copytree(stopped, tmp_path / "state")
    fresh = TPipe(TSD.create("micro", torch.float32, device="cpu"))
    out = fresh.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(d), **KW)
    assert out.resumed_from_step == 2
    assert_same_bits(out, ref)


def test_stop_and_resume_with_eta(pipe, tmp_path):
    kw = dict(KW_STEP2, eta=1.0)
    want = pipe(seed=SEED, **kw)
    with pytest.raises(Stop):
        pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(tmp_path), on_segment=stop_after(2), **kw)
    out = pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=str(tmp_path), **kw)
    assert out.resumed_from_step == 2
    assert_same_bits(out, want)


def test_batch_resumable_equals_generate_batch(pipe, tmp_path):
    seeds, prompts = [SEED, SEED + 1], [META, META_2]
    kw = {k: v for k, v in KW_STEP2.items() if k != "meta_prompt"}
    want = pipe.generate_batch(seeds, meta_prompts=prompts, **kw)
    with pytest.raises(Stop):
        pipe.generate_batch_resumable(seeds, checkpoint_every=2, state_dir=str(tmp_path), meta_prompts=prompts,
                                      on_segment=stop_after(2), **kw)
    outs = pipe.generate_batch_resumable(seeds, checkpoint_every=2, state_dir=str(tmp_path), meta_prompts=prompts,
                                         **kw)
    assert [o.resumed_from_step for o in outs] == [2, 2]
    assert [o.prompt for o in outs] == [w.prompt for w in want]
    for got, w in zip(outs, want):
        assert_same_bits(got, w)
    # one process: a data-parallel mesh of one rank is the same run
    outs = pipe.generate_batch_resumable(seeds, checkpoint_every=2, state_dir=str(tmp_path), meta_prompts=prompts,
                                         mesh=make_mesh(), **kw)
    for got, w in zip(outs, want):
        assert_same_bits(got, w)


def test_identity_guard_starts_fresh(pipe, tmp_path):
    """State of another seed, option or dtype is never resumed; the same run's is."""
    d = str(tmp_path)
    with pytest.raises(Stop):
        pipe.generate_resumable(seed=SEED, checkpoint_every=2, state_dir=d, on_segment=stop_after(2), **KW_STANDARD)
    first = []

    def record(done, total):
        first.append(done)
        raise Stop

    bf16 = TPipe(TSD.create("micro", torch.bfloat16, device="cpu"))
    for p, seed, kw in ((pipe, SEED + 1, KW_STANDARD), (pipe, SEED, dict(KW_STANDARD, guidance_scale=5.0)),
                        (bf16, SEED, KW_STANDARD), (pipe, SEED, KW_STANDARD)):
        with pytest.raises(Stop):
            p.generate_resumable(seed=seed, checkpoint_every=2, state_dir=d, on_segment=record, **kw)
    # a fresh start first stops at step 2; the same run resumes at 2 and stops at 4
    assert first == [2, 2, 2, 4]
    assert "device=cpu" in pipe._identity_parts() and "dtype=torch.float32" in pipe._identity_parts()


def _diag(steps, value, batch=None):
    lead = (steps,) if batch is None else (batch, steps)
    return StepDiag(**{f.name: np.full(lead + (2,), value, np.float32) for f in dataclasses.fields(StepDiag)})


def test_torn_and_foreign_files_are_skipped(tmp_path):
    lat = torch.arange(8, dtype=torch.bfloat16).reshape(1, 2, 2, 2)
    gens = [torch.Generator().manual_seed(1).get_state()]
    ckpt.save_state(tmp_path, "id", 2, lat, _diag(2, 0.0, 1), seg_start=0, generators=gens)
    ckpt.save_state(tmp_path, "id", 4, lat + 1, _diag(2, 1.0, 1), seg_start=2, generators=gens)
    good = ckpt._path(tmp_path, "id", 4).read_bytes()
    ckpt._path(tmp_path, "id", 6).write_bytes(good[: len(good) // 2])  # torn mid-write
    ckpt.save_state(tmp_path, "other", 8, lat, _diag(2, 5.0, 1), seg_start=6)
    os.replace(ckpt._path(tmp_path, "other", 8), ckpt._path(tmp_path, "id", 8))  # foreign identity inside
    step, got, diags, states = ckpt.latest_state(tmp_path, "id")
    assert step == 4 and got.dtype == torch.bfloat16 and torch.equal(got, lat + 1)
    np.testing.assert_array_equal(diags.total_loss[0, :, 0], [0, 0, 1, 1])
    assert len(states) == 1 and torch.equal(torch.from_numpy(np.array(states[0])), gens[0])
    assert ckpt.latest_state(tmp_path, "nothing") is None
    ckpt.clear_state(tmp_path, "id")
    assert state_files(tmp_path) == []


def test_jax_state_files_stitch_in_the_port(tmp_path):
    """Files the JAX package's ``save_state`` wrote (numpy diagnostics) are
    stitched by the port's ``latest_state`` into the JAX package's arrays."""
    rng = np.random.default_rng(0)

    def jdiag(steps, batch):
        return JStepDiag(**{f.name: rng.standard_normal((batch, steps, 3)).astype(np.float32)
                            for f in dataclasses.fields(JStepDiag)})

    lat = rng.standard_normal((2, 1, 4, 4, 4)).astype(np.float32)
    for a, b in ((0, 2), (2, 4), (4, 5)):
        jckpt.save_state(str(tmp_path), "jid", b, lat + b, jdiag(b - a, 2), seg_start=a)
    jstep, jlat, jd = jckpt.latest_state(str(tmp_path), "jid", axis=1)
    step, got, d, states = ckpt.latest_state(tmp_path, "jid")
    assert step == jstep == 5 and states is None
    np.testing.assert_array_equal(got, jlat)
    for f in dataclasses.fields(StepDiag):
        np.testing.assert_array_equal(getattr(d, f.name), np.asarray(getattr(jd, f.name)), err_msg=f.name)


def test_cli_checkpoint_every_writes_the_same_png_bytes(tmp_path, capsys):
    argv = ["--meta_prompt", META, "--model", "micro", "--device", "cpu", "--dtype", "float32",
            "--run_standard_sd", "true", "--n_inference_steps", "4", "--seeds", "1"]
    trees = {}
    for name, extra in (("plain", []), ("resumable", ["--checkpoint_every", "2"])):
        root = tmp_path / name
        tcli.main(argv + ["--output_path", str(root)] + extra)
        trees[name] = {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*.png")}
    assert "resumable, every 2 steps" in capsys.readouterr().out
    assert not list((tmp_path / "resumable" / "state").glob("*"))
    assert set(trees["plain"]) == set(trees["resumable"]) and len(trees["plain"]) >= 2
    for rel, data in trees["plain"].items():
        assert trees["resumable"][rel] == data, rel
