"""Data and tensor parallelism in the port (``parallel/``, ``mesh=`` on the
batch entries, the CLI over several processes, the served mesh) on the CPU:
two gloo ranks, micro in float32, the JAX package's weights
(``params_from_jax``, through a native checkpoint that the ranks load).

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
* ``to_host`` of bfloat16, bool, float16 and int32 leaves, bit for bit;
* the tensor axis, ``{"data": 1, "tensor": 2}``: standard SD against the
  one-process run and against JAX's ``generate_batch`` over the same mesh
  (1e-4), a guided 2-step run against the data-only run (5e-3, as
  ``tests/test_parallel.py:75-95``), and one guidance eval's loss and
  latent gradient (plain, deep-latent, paint-with-words with a gate),
  equal on both ranks and within 1e-5 relative of one process, and the
  maps a forward captures (head means, per-head);
* the served mesh: a ``BatchingEngine`` over ``{"data": 2}`` on rank 0,
  ``server.follow`` on rank 1; the served PNGs bitwise each rank's
  one-process row, and a follower fault failing rank 0's ticket in time.

The mesh, the slicing (``shard_unet``, GEGLU's halves, the bias after the
sum, replicated layers), Megatron's f and g on a group of one, the
refusals and the tensor-parallel rules are checked in this process.
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
from hypothesis import given, settings, strategies as st

from guided_attention_tpu.parallel import mesh as jmesh
from guided_attention_tpu.parallel import multihost as jmultihost
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe

from guided_attention_tpu_torch.frontends import cli as tcli
from guided_attention_tpu_torch.models import io as tio
from guided_attention_tpu_torch.models import unet as tunet
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.convert import params_from_jax
from guided_attention_tpu_torch.parallel import mesh as tmesh
from guided_attention_tpu_torch.parallel import multihost
from guided_attention_tpu_torch.parallel import tensor as ttensor
from guided_attention_tpu_torch.pipeline import StepDiag
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe

from torch_port_helpers import jax_draws, jax_micro_bundle, jax_param_shapes
from torch_port_parallel_child import EVAL_CASES, FAIL_TIMEOUT_S, SEEDS, STANDARD, TP_SEEDS, cli_argv

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
        jax_tp = jp.generate_batch(TP_SEEDS, mesh=jmesh.make_mesh({"data": 1, "tensor": 2}), **STANDARD)
        tcli.main(cli_argv(root / "ckpt", root / "single", "--batch_size", "1"))
    finally:
        _wait(procs, logs, CHILD_TIMEOUT_S)
        for f in files:
            f.close()
    ranks = [dict(np.load(root / f"out{r}.npz")) for r in (0, 1)]
    return dict(root=root, ranks=ranks, jax_std=jax_std, jax_tp=jax_tp, logs=[log.read_text() for log in logs])


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


def test_tensor_axis_standard_matches_one_process_and_jax(run):
    r0, r1 = run["ranks"]
    assert str(r0["tp_backend"]) == "gloo" and "tensor group [0, 1] on gloo (ranks share cpu)" in run["logs"][0]
    got = r0["tp_standard_latents"]
    np.testing.assert_array_equal(got, r1["tp_standard_latents"])
    np.testing.assert_allclose(got, r0["one_standard_latents"], atol=1e-4, rtol=0)
    want = np.stack([np.asarray(o.latents, np.float32) for o in run["jax_tp"]]).reshape(got.shape)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tensor_axis_guided_matches_the_data_only_run(run):
    r0, r1 = run["ranks"]
    np.testing.assert_array_equal(r0["tp_guided_latents"], r1["tp_guided_latents"])
    assert (r0["tp_guided_diag_refine_iters"][:, 0] > 0).all()
    np.testing.assert_allclose(r0["tp_guided_latents"], r0["guided_ref_latents"], atol=5e-3, rtol=0)
    assert r0["tp_guided_has_images"].all() and not r1["tp_guided_has_images"].any()


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_tensor_axis_eval_loss_and_gradient(run, case):
    """Equal on both ranks (the gradient reaching f is whole on each), and
    one process's within 1e-5 relative: plain, deep-latent (the gradient of
    the bottleneck features), and paint-with-words with a nonzero gate (a
    gradient through the score max over both ranks' heads)."""
    r0, r1 = run["ranks"]
    loss, grad = r0[f"eval_{case}_tp_loss"], r0[f"eval_{case}_tp_grad"]
    assert loss == r1[f"eval_{case}_tp_loss"]
    np.testing.assert_array_equal(grad, r1[f"eval_{case}_tp_grad"])
    want_loss, want_grad = r0[f"eval_{case}_one_loss"], r0[f"eval_{case}_one_grad"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert np.abs(grad - want_grad).max() <= 1e-5 * np.abs(want_grad).max()
    assert np.abs(want_grad).max() > 0


def test_tensor_axis_maps_are_the_whole_layers(run):
    """The head means (cross and self) and the per-head cross maps a forward
    captures are every head's, equal on both ranks and one process's."""
    r0, r1 = run["ranks"]
    keys = [k[len("maps_tp_"):] for k in r0 if k.startswith("maps_tp_")]
    assert len(keys) == 6 and r0["maps_tp_down_cross_perhead"].shape[2] == 2  # [layers, B, heads, Nq, K]
    for key in keys:
        np.testing.assert_array_equal(r0[f"maps_tp_{key}"], r1[f"maps_tp_{key}"], err_msg=key)
        np.testing.assert_allclose(r0[f"maps_tp_{key}"], r0[f"maps_one_{key}"], atol=1e-6, rtol=0, err_msg=key)


def test_served_mesh_is_each_ranks_one_process_row(run):
    r0, r1 = run["ranks"]
    for b, res in enumerate((r0, r1)):
        np.testing.assert_array_equal(r0["served_images"][b], res["serve_ref_images"])
        np.testing.assert_array_equal(r0["served_latents"][b], res["serve_ref_latents"])


def test_a_failed_follower_fails_the_ticket_in_time(run):
    r0, r1 = run["ranks"]
    assert str(r0["fail_error"]) == "rank 1: RuntimeError: injected follower fault"
    assert float(r0["fail_s"]) < FAIL_TIMEOUT_S and int(r0["served_stats_errors"]) == 1
    assert int(r1["followed"]) == 2  # the first batch and the failed one; the stop ended it


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
    # the tensor axis is in; a mesh larger than the process group is not
    for shape in ({"data": 1, "tensor": 2}, {"tensor": 4}):
        with pytest.raises(ValueError, match="needs .* processes"):
            tmesh.make_mesh(shape)
    m = tmesh.Mesh(("data", "tensor"), (2, 2), rank=3)
    assert (m.data_index, m.tensor_index, m.tensor_rows, m.row_sources) == (1, 1, [[0, 1], [2, 3]], [0, 2])
    m = tmesh.Mesh(("tensor", "data"), (2, 3), rank=4)
    assert (m.data_index, m.tensor_index, m.tensor_rows, m.row_sources) == (1, 1, [[0, 3], [1, 4], [2, 5]], [0, 1, 2])


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


# ---- the tensor axis's slicing and collectives, in one process -----------
def _tp_unets(unet, t):
    return [tmesh.shard_unet(unet, tmesh.Mesh(("tensor",), (t,), rank=r)) for r in range(t)]


def _simulate_group(modules, x, monkeypatch, **kw):
    """Each rank's module on ``x``, with g (``reduce_from_tensor``) made the
    sum of every rank's input to it, as a group of ``len(modules)`` ranks
    computes it; returns rank 0's output."""
    seen = []
    monkeypatch.setattr(tunet, "reduce_from_tensor", lambda y, tp: seen.append(y) or y)
    for m in modules:
        m(x, **kw)
    total = sum(seen)
    monkeypatch.setattr(tunet, "reduce_from_tensor", lambda y, tp: total)
    return modules[0](x, **kw)


@pytest.mark.parametrize("t", [2, 4])
def test_shard_unet_slices_geglu_by_halves(micro_pipe, t):
    """Each rank takes its slice of the hidden half and of the gate half:
    the ranks' h * gelu(gate), side by side, are the whole layer's."""
    unet = micro_pipe.sd.unet
    name = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0"
    whole = unet.get_submodule(name)
    x = torch.randn(2, 5, whole.proj.weight.shape[1], generator=torch.Generator().manual_seed(0))
    parts = [u.get_submodule(name)(x) for u in _tp_unets(unet, t)]
    torch.testing.assert_close(torch.cat(parts, dim=-1), whole(x), rtol=1e-6, atol=1e-6)
    # a contiguous slice of the 2 x inner rows would give rank 0 no gate
    inner = whole.proj.weight.shape[0] // 2
    r0 = _tp_unets(unet, t)[0].get_submodule(name).proj.weight
    torch.testing.assert_close(r0[inner // t:], whole.proj.weight[inner: inner + inner // t], rtol=0, atol=0)


@pytest.mark.parametrize("layer", ["attn1", "attn2", "ff"])
def test_the_replicated_bias_is_added_once_after_the_sum(micro_pipe, monkeypatch, layer):
    unet = micro_pipe.sd.unet
    name = f"up_blocks.1.attentions.0.transformer_blocks.0.{layer}"
    whole = unet.get_submodule(name)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 64, generator=g)
    kw = {} if layer != "attn2" else {"context": torch.randn(2, 77, 64, generator=g)}
    mods = [u.get_submodule(name) for u in _tp_unets(unet, 2)]
    bias = mods[0].to_out[0].bias if layer != "ff" else mods[0].net[2].bias
    assert bias is (whole.to_out[0].bias if layer != "ff" else whole.net[2].bias)  # shared, whole
    want = whole(x, **kw)
    got = _simulate_group(mods, x, monkeypatch, **kw)
    if layer != "ff":
        want, got = want[0], got[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_layer_the_axis_does_not_divide_stays_replicated(micro_pipe, capsys):
    """micro has 2 heads and a feed-forward width of 4 x dim: at t = 3 no
    layer divides, and each shares the whole layer's tensors; at t = 2 every
    layer is sharded and the convolutions stay shared."""
    unet = micro_pipe.sd.unet
    rep = tmesh.shard_unet(unet, tmesh.Mesh(("tensor",), (3,), rank=0))
    assert "30 layer(s), which stay replicated" in capsys.readouterr().err
    for (n, p), (n2, p2) in zip(unet.named_parameters(), rep.named_parameters()):
        assert n == n2 and p is p2
    assert not any(getattr(m, "tp", None) for m in rep.modules())
    two = tmesh.shard_unet(unet, tmesh.Mesh(("tensor",), (2,), rank=1))
    assert two.conv_in.weight is unet.conv_in.weight and two.down_blocks[0].resnets[0].conv1.weight is \
        unet.down_blocks[0].resnets[0].conv1.weight
    assert sum(isinstance(m, tunet.CrossAttention) and m.tp is not None for m in two.modules()) == 20
    assert unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.tp is None  # the original is untouched
    assert tmesh.shard_unet(unet, tmesh.Mesh(("data",), (1,))) is unet


@pytest.fixture
def group_of_one(tmp_path):
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield ttensor.TensorAxis(torch.distributed.new_group([0]), 1, 0)
    finally:
        torch.distributed.destroy_process_group()


def test_f_and_g_backward_on_a_group_of_one(group_of_one):
    """f: identity forward, the group's sum backward; g: the sum forward,
    identity backward; the score max: amax's value and its gradient, split
    among ties; the per-head gather: every head in place."""
    axis = group_of_one
    ttensor.reset_collectives()
    x = torch.tensor([[1.0, 3.0, 3.0], [2.0, -1.0, 0.5]], requires_grad=True)
    y = ttensor.copy_to_tensor(x, axis)
    (gx,) = torch.autograd.grad((y * torch.arange(6.0).reshape(2, 3)).sum(), x)
    torch.testing.assert_close(gx, torch.arange(6.0).reshape(2, 3), rtol=0, atol=0)
    (gx,) = torch.autograd.grad((ttensor.reduce_from_tensor(x, axis) * 2).sum(), x)
    torch.testing.assert_close(gx, torch.full((2, 3), 2.0), rtol=0, atol=0)
    top = ttensor.tensor_amax(x, (1,), axis)
    want = x.amax(dim=1, keepdim=True)
    torch.testing.assert_close(top, want, rtol=0, atol=0)
    w = torch.tensor([[5.0], [7.0]])
    (got,) = torch.autograd.grad((top * w).sum(), x)
    (ref,) = torch.autograd.grad((want * w).sum(), x)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)  # [[0, 2.5, 2.5], [7, 0, 0]]
    local = torch.randn(2, 3, 4, 5)
    torch.testing.assert_close(ttensor.gather_heads(local, 3, axis), local, rtol=0, atol=0)
    assert ttensor.COLLECTIVES["all_reduce"] == 6 and ttensor.COLLECTIVES["bytes"] > 0
    assert multihost.process_count() == 1


@settings(max_examples=40, deadline=None)
@given(t=st.sampled_from([1, 2, 4, 8]), per=st.integers(1, 5), halves=st.sampled_from([1, 2]),
       cols=st.integers(1, 4), dim=st.sampled_from([0, 1]))
def test_the_ranks_slices_tile_the_whole_weight(t, per, halves, cols, dim):
    """Concatenating the ranks' slices, half by half, rebuilds the weight;
    ``TensorAxis.local`` tiles the features in rank order."""
    n = t * per * halves
    w = torch.arange(float(n * cols)).reshape(n, cols)
    w = w if dim == 0 else w.T.contiguous()
    slices = [tmesh._sharded_copy(w, dim, ttensor.TensorAxis(None, t, r), halves) for r in range(t)]
    assert all(s.shape[dim] == n // t for s in slices)
    rebuilt = [torch.cat([s.chunk(halves, dim=dim)[h] for s in slices], dim=dim) for h in range(halves)]
    torch.testing.assert_close(torch.cat(rebuilt, dim=dim), w, rtol=0, atol=0)
    assert [ttensor.TensorAxis(None, t, r).local(t * per) for r in range(t)] == \
        [slice(r * per, (r + 1) * per) for r in range(t)]
