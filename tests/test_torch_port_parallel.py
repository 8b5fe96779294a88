"""Data parallelism in the port (``parallel/``, ``mesh=`` on the batch
entries, the CLI over several processes) on the CPU: two gloo ranks, micro
in float32, the JAX package's weights (``params_from_jax``, through a native
checkpoint that the ranks load).

One launch of two child processes (one torch thread each, a ``file://``
store in ``tmp_path``, so no port can collide) runs every multi-process case
and saves each rank's outputs; the tests here read them:

* the guided batch of ``tests/test_multihost_2proc.py`` (seeds 1-4, one
  box, threshold 0.5): the whole batch on both ranks, bitwise equal between
  them and to the one-process ``generate_batch`` of each rank's rows (run
  in the rank after), which refine at step 0; images on rank 0 only;
* multi-prompt: the global batch stays 4, and the same seed under another
  box gives other latents;
* kill and resume (``tests/test_multihost_2proc.py:178``): 3 steps in
  segments of 1, both ranks stopped after the first, then resumed from the
  shared whole-batch state: bitwise the uninterrupted run, diagnostics of 3
  steps;
* the CLI at ``--num_processes 2``: rank 1 writes nothing, and rank 0's
  tree is a one-process ``--batch_size 1`` run's, PNG for PNG;
* standard SD from JAX's initial latents against JAX's ``generate_batch``
  over a two-device mesh (1e-4, as ``tests/test_parallel.py:42``);
* ``to_host`` of bfloat16, bool, float16 and int32 leaves, bit for bit.

The mesh, the slicing, the refusals and the tensor-parallel rules are
checked in this process.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from guided_attention_tpu.parallel import mesh as jmesh
from guided_attention_tpu.parallel import multihost as jmultihost
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe

from guided_attention_tpu_torch.frontends import cli as tcli
from guided_attention_tpu_torch.models import io as tio
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.convert import params_from_jax
from guided_attention_tpu_torch.parallel import mesh as tmesh
from guided_attention_tpu_torch.parallel import multihost
from guided_attention_tpu_torch.pipeline import StepDiag
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe

from torch_port_helpers import jax_draws, jax_micro_bundle, jax_param_shapes
from torch_port_parallel_child import SEEDS, STANDARD, cli_argv

REPO = str(Path(__file__).resolve().parent.parent)
CHILD = os.path.join(REPO, "tests", "torch_port_parallel_child.py")
CHILD_TIMEOUT_S = 300
FIELDS = ["latents"] + [f"diag_{f.name}" for f in dataclasses.fields(StepDiag)]
ROWS = (slice(0, 2), slice(2, 4))


def _wait(procs, logs, timeout_s):
    """Wait for every child; a child that fails, or the deadline, kills them
    all (a rank left waiting in a collective would hang until gloo's
    timeout)."""
    deadline = time.monotonic() + timeout_s
    while any(p.poll() is None for p in procs):
        failed = any(p.returncode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait(timeout=30)
            break
        time.sleep(0.1)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed (rc {p.returncode}):\n{log.read_text()[-4000:]}"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' saved outputs (each with the one-process batch of its
    rows), JAX's standard-SD batch over a two-device mesh, and a
    one-process CLI run, all on the same weights."""
    root = tmp_path_factory.mktemp("two_ranks")
    jsd = jax_micro_bundle()
    params = jax.tree_util.tree_map(np.asarray, jsd.params)
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(params)
    tio.save_params(str(root / "ckpt"), tsd)
    jp = JPipe(jsd)
    np.save(root / "jax_latents.npy", np.concatenate([jax_draws(jp, s)[0] for s in SEEDS]))
    for r in (0, 1):
        (root / f"rank{r}").mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    logs = [root / f"rank{r}.log" for r in (0, 1)]
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen([sys.executable, CHILD, str(r), str(root)], cwd=REPO, env=env, stdout=f,
                              stderr=subprocess.STDOUT) for r, f in enumerate(files)]
    try:
        # meanwhile, the references that need JAX or a process outside the group
        jax_std = jp.generate_batch(SEEDS, mesh=jmesh.make_mesh({"data": 2}), **STANDARD)
        tcli.main(cli_argv(root / "ckpt", root / "single", "--batch_size", "1"))
    finally:
        _wait(procs, logs, CHILD_TIMEOUT_S)
        for f in files:
            f.close()
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in (0, 1)]
    return dict(root=root, ranks=ranks, jax_std=jax_std)


def test_guided_batch_is_whole_on_both_ranks_and_each_rank_runs_its_rows(run):
    r0, r1 = run["ranks"]
    for f in FIELDS:
        key = f"guided_{f}"
        assert r0[key].shape[0] == 4, key
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
        for res, rows in zip(run["ranks"], ROWS):
            np.testing.assert_array_equal(res[key][rows], res[f"guided_ref_{f}"], err_msg=key)
    assert (r0["guided_diag_refine_iters"][:, 0] > 0).all()
    assert np.isfinite(r0["guided_latents"]).all()
    assert not np.array_equal(r0["guided_latents"][0], r0["guided_latents"][1])


def test_images_exist_on_rank_0_only(run):
    r0, r1 = run["ranks"]
    assert r0["guided_has_images"].all() and not r1["guided_has_images"].any()
    assert "guided_images" not in r1
    for res, rows in zip(run["ranks"], ROWS):
        np.testing.assert_array_equal(r0["guided_images"][rows], res["guided_ref_images"])


def test_multi_prompt_batch_stays_four_and_each_box_is_its_own(run):
    r0, r1 = run["ranks"]
    lat = r0["multi_latents"]
    assert lat.shape[0] == 4 and np.isfinite(lat).all()
    np.testing.assert_array_equal(lat, r1["multi_latents"])
    # the same seed under another box takes another trajectory
    assert not np.array_equal(lat[0], lat[2])
    for f in FIELDS:
        for res, rows in zip(run["ranks"], ROWS):
            np.testing.assert_array_equal(r0[f"multi_{f}"][rows], res[f"multi_ref_{f}"], err_msg=f)


def test_killed_and_resumed_batch_equals_the_uninterrupted_run(run):
    for res in run["ranks"]:
        assert list(res["resumed_from"]) == [1] * 4
        assert list(res["state_files"])[-1].endswith("_0001.msgpack")
        assert int(res["state_left"]) == 0
        assert res["resumed_diag_total_loss"].shape[:2] == (4, 3)
        for f in FIELDS:
            np.testing.assert_array_equal(res[f"resumed_{f}"], res[f"uninterrupted_{f}"], err_msg=f)
    np.testing.assert_array_equal(run["ranks"][0]["resumed_latents"], run["ranks"][1]["resumed_latents"])


def test_cli_over_two_ranks_writes_one_tree_equal_to_batch_size_1(run):
    root = run["root"]
    assert list((root / "rank1").iterdir()) == []
    got = {p.relative_to(root / "rank0" / "tree"): p for p in (root / "rank0" / "tree").rglob("*") if p.is_file()}
    want = {p.relative_to(root / "single"): p for p in (root / "single").rglob("*") if p.is_file()}
    assert sorted(got) == sorted(want)
    pngs = [k for k in want if k.suffix == ".png"]
    assert len(pngs) >= 10
    for k in pngs:
        assert got[k].read_bytes() == want[k].read_bytes(), k


def test_standard_batch_matches_jax_over_a_two_device_mesh(run):
    got = run["ranks"][0]["standard_latents"]
    want = np.stack([np.asarray(o.latents, np.float32) for o in run["jax_std"]]).reshape(got.shape)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got, run["ranks"][1]["standard_latents"])


def test_to_host_gathers_every_dtype_bit_for_bit(run):
    r0, r1 = run["ranks"]
    for key, mine in (("to_host_bf16_bits", "mine_bf16_bits"), ("to_host_f16", "mine_f16")):
        want = np.concatenate([r0[mine], r1[mine]])
        np.testing.assert_array_equal(r0[key].view(np.uint8), want.view(np.uint8))
        np.testing.assert_array_equal(r1[key].view(np.uint8), want.view(np.uint8))
    for res in (r0, r1):
        np.testing.assert_array_equal(res["to_host_int32"], np.array([[0, 1], [2, 3], [10, 11], [12, 13]]))
        assert res["to_host_bool"].dtype == bool
        np.testing.assert_array_equal(res["to_host_bool"].ravel(), [True, True, False, True])


# ---- one process -------------------------------------------------------
def test_make_mesh_defaults_and_errors():
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1} and m.size == 1 and m.ranks.tolist() == [0]
    assert tmesh.make_mesh({"data": 1, "tensor": 1}).ranks.shape == (1, 1)
    with pytest.raises(ValueError, match="processes"):
        tmesh.make_mesh({"data": 2})
    with pytest.raises(ValueError, match="axes"):
        tmesh.make_mesh({"pipeline": 1})
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh({"data": 0})
    for shape in ({"data": 1, "tensor": 2}, {"tensor": 4}):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item 7"):
            tmesh.make_mesh(shape)


def test_local_batch_slice_and_helpers_at_one_process():
    multihost.initialize(None, None, None)
    multihost.initialize("127.0.0.1:1234", 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and multihost.process_count() == 1
    for n in (1, 4, 8):
        assert multihost.local_batch_slice(n) == jmultihost.local_batch_slice(n)
    x = {"a": torch.arange(4), "b": np.ones((2, 2))}
    assert multihost.to_host(x) is x
    assert multihost.gather_to_primary(x["a"]) is x["a"]
    assert multihost.rank_device("cpu") == torch.device("cpu")


def test_a_batch_that_does_not_divide_raises(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="pad it"):
        multihost.local_batch_slice(4)
    assert multihost.local_batch_slice(6) == slice(0, 2)


@pytest.fixture(scope="module")
def micro_pipe():
    return TPipe(TSD.create("micro", torch.float32, device="cpu"))


def test_a_mesh_of_one_process_is_bitwise_no_mesh(micro_pipe):
    kw = dict(meta_prompt="a [dog:.2,.3] x", num_inference_steps=2, thresholds={0: 0.5})
    want = micro_pipe.generate_batch([5, 6], **kw)
    got = micro_pipe.generate_batch([5, 6], mesh=tmesh.make_mesh({"data": 1}), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.latents, w.latents)
        np.testing.assert_array_equal(g.images_u8, w.images_u8)
        for f in dataclasses.fields(StepDiag):
            np.testing.assert_array_equal(getattr(g.diagnostics, f.name), getattr(w.diagnostics, f.name))


def test_tp_rules_select_the_jax_packages_parameters():
    """Through the name map of ``params_from_jax`` (each JAX leaf filled with
    its own index), the port's rules pick the parameters JAX's pick, with
    the partition of each 2-D weight transposed (torch's [out, in])."""
    shapes = jax_param_shapes("micro", components=("unet",))["unet"]
    paths = []

    def tag(path, leaf):
        paths.append("/" + "/".join(p.key for p in path))
        return np.full(leaf.shape, len(paths) - 1, np.float32)

    tagged = jax.tree_util.tree_map_with_path(tag, shapes)
    unet = TSD.create("micro", torch.float32, device="cpu").unet
    state = params_from_jax(tagged, unet, "unet")
    to_jax = {name: paths[int(t.reshape(-1)[0])] for name, t in state.items()}
    mesh = jmesh.make_mesh({"data": 4, "tensor": 2})
    want = {p: tuple(jmesh._spec_for(p, jmesh.DEFAULT_TP_RULES, mesh)) for p in paths}
    want = {p: s for p, s in want.items() if s}
    got = {}
    for name in state:
        spec = tmesh.tp_spec(name)
        if spec is not None:
            got[to_jax[name]] = spec[::-1] if len(spec) == 2 else spec
    assert got == want
    assert len(got) >= 6
