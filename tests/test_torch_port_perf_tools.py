"""The port's measuring tools: ``perf_unet``'s chains against the JAX UNet,
``profile``'s join of kernels to modules and ops, ``perf_host_tail``'s
drive, and what each refuses.

* ``perf_unet``'s eager chains at micro in float32, N = 3, on numpy-seeded
  latents and context and the timesteps 500, 499, 498, with the same
  weights (``params_from_jax``), against the JAX micro UNet applied three
  times, as the JAX script's scan body does (``scripts/perf_unet.py``,
  jitted once in a module fixture): the CFG chain's last eps; the eval
  chain's losses, first gradient and last latent. Tolerance: 1e-4
  relative to the reference's largest magnitude, the repo's figure for a
  micro UNet in float32 (the sums run in another order); the gradient
  too. Measured here: the CFG eps 6.0e-6, the first gradient 2.0e-6, the
  losses 7e-8-2.2e-7, the last latent 3e-10.
* The join on hand-built events: nested module ranges, a kernel launched
  by a module's own code, a backward kernel tied to its forward module by
  ``sequence_nr`` (past an op before it that read the same number), a
  kernel outside every module (the innermost port function's range around
  its op), one outside both (unattributed), one the profiler tied to no op,
  and the closure.
* ``profile --device cpu --model micro --steps 2``: the join closes over
  the CPU ops, the new keys are there, ``--analyze`` prints the table again.
* ``perf_host_tail --quick --steps 2 --reps 1``.
* The CUDA defaults raise without a card; flags whose route the kernels do
  not take raise.
"""
import json
import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from guided_attention_tpu_torch import perf_host_tail, perf_unet
from guided_attention_tpu_torch import profile as port_profile
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.configs import get_config
from guided_attention_tpu_torch.profile import (DIRECT, MODULE_PREFIX, NOT_LINKED, SOURCE_PREFIX, UNATTRIBUTED, Event,
                                                join)

from torch_port_helpers import jax_micro_bundle

REL = 1e-4
N_CHAIN = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jsd = jax_micro_bundle()
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return jsd, tsd


@pytest.fixture(scope="module")
def jax_unet(pair):
    """The JAX script's two bodies, jitted once: one CFG forward, and one
    eval's loss and gradient."""
    jsd, _tsd = pair
    unet, params = jsd.unet, jsd.params["unet"]
    capture = frozenset({("cross", 16)})

    def fwd(p, h, t, c):
        return unet.apply({"params": p}, h, t, c)[0]

    def loss(h, p, t, c):
        eps, aux = unet.apply({"params": p}, h, t, c, capture=capture)
        maps = sum(jnp.sum(m) for k in aux["maps"] for m in aux["maps"][k])
        return jnp.mean(eps.astype(jnp.float32)) + 0.001 * maps

    return params, jax.jit(fwd), jax.jit(jax.value_and_grad(loss))


def _inputs(batch: int):
    rng = np.random.default_rng(14 + batch)
    x = rng.standard_normal((batch, 16, 16, 4)).astype(np.float32)
    return x, rng.standard_normal((batch, 77, 64)).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())


def _timesteps():
    return perf_unet.T0 - np.arange(N_CHAIN)


def test_cfg_chain_matches_jax(pair, jax_unet):
    _jsd, tsd = pair
    params, fwd, _vg = jax_unet
    x, ctx = _inputs(2)
    h = jnp.asarray(x)
    for t in _timesteps():
        h = fwd(params, h, jnp.int32(t), jnp.asarray(ctx)).astype(h.dtype)
    got = perf_unet.cfg_chain(tsd.unet, torch.from_numpy(x), torch.from_numpy(ctx), torch.from_numpy(_timesteps()))
    assert got.shape == (2, 16, 16, 4)
    assert _rel(got, h) < REL


def test_eval_chain_matches_jax(pair, jax_unet):
    _jsd, tsd = pair
    params, _fwd, vg = jax_unet
    x, ctx = _inputs(1)
    h, losses, grads = jnp.asarray(x), [], []
    for t in _timesteps():
        loss, g = vg(h, params, jnp.int32(t), jnp.asarray(ctx))
        losses.append(float(loss))
        grads.append(np.asarray(g))
        h = (h - perf_unet.STEP * g).astype(h.dtype)
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)
    _loss0, grad0 = perf_unet.eval_step(tsd.unet, xt, int(_timesteps()[0]), ct)
    assert float(grad0.abs().max()) > 0
    assert _rel(grad0, grads[0]) < REL
    got_h, got_losses = perf_unet.eval_chain(tsd.unet, xt, ct, torch.from_numpy(_timesteps()))
    assert got_losses.shape == (N_CHAIN,)
    for a, b in zip(got_losses.tolist(), losses):
        assert abs(a - b) <= REL * abs(b)
    assert _rel(got_h, h) < REL


def _kinds():
    return {"unet": "UNet2DCondition", "unet.down_blocks.0": "_Block", "unet.down_blocks.0.resnets.0": "ResnetBlock2D",
            "unet.down_blocks.0.resnets.0.norm1": "GroupNorm", "unet.up_blocks.0": "_Block"}


def _hand_built_events():
    """Thread 1 runs the forward, thread 2 the backward (as the autograd
    engine's device thread does on CUDA)."""
    ev = [
        Event(MODULE_PREFIX + "unet", None, 0.0, 1),  # 0
        Event(MODULE_PREFIX + "unet.up_blocks.0", 0, 0.1, 1),  # 1
        # an op that read sequence number 10 but made no node; the conv below made it
        Event("aten::to", 1, 0.2, 1, seq=10, work=(("copy_kernel_a", 1.0),)),  # 2
        Event(MODULE_PREFIX + "unet.down_blocks.0", 0, 1.0, 1),  # 3
        Event(MODULE_PREFIX + "unet.down_blocks.0.resnets.0", 3, 1.1, 1),  # 4
        Event("aten::conv2d", 4, 1.2, 1, seq=10),  # 5
        Event("aten::convolution", 5, 1.3, 1, seq=10, work=(("implicit_gemm_conv_fprop", 5.0),)),  # 6
        Event(MODULE_PREFIX + "unet.down_blocks.0.resnets.0.norm1", 4, 2.0, 1,
              work=(("flash_self_fwd_kernel", 3.0),)),  # 7: launched by the module's own code
        Event("aten::copy_", 7, 2.1, 1, seq=11, work=(("copy_kernel_b", 0.5),)),  # 8
        # outside every module: a port function's range, an op in it, the op's own kernel-launching op
        Event(SOURCE_PREFIX + "guidance/losses.py(47): compute_token_stats", None, 5.0, 1),  # 9
        Event("aten::einsum", 9, 5.1, 1),  # 10
        Event("aten::mul", 10, 5.2, 1, seq=12, work=(("vectorized_elementwise_kernel", 1.0),)),  # 11
        # outside every module and every port frame
        Event("aten::sum", None, 6.0, 1, seq=13, work=(("reduce_kernel", 0.25),)),  # 12
        # the innermost of two port functions' ranges
        Event(SOURCE_PREFIX + "pipeline.py(312): guided_update", None, 7.0, 1),  # 13
        Event(SOURCE_PREFIX + "pipeline.py(285): guidance_eval", 13, 7.1, 1),  # 14
        Event("aten::copy_", 14, 7.2, 1, seq=14, work=(("copy_kernel_c", 0.125),)),  # 15
        # the backward, on thread 2
        Event("autograd::engine::evaluate_function: ConvolutionBackward0", None, 100.0, 2, seq=10,
              fwd_thread=1),  # 16
        Event("ConvolutionBackward0", 16, 100.1, 2, seq=10, fwd_thread=1),  # 17
        Event("aten::convolution_backward", 17, 100.2, 2, work=(("dgrad_kernel", 4.0), ("wgrad_kernel", 2.0))),  # 18
        Event("autograd::engine::evaluate_function: MulBackward0", None, 110.0, 2, seq=12, fwd_thread=1),  # 19
        Event("aten::mul", 19, 110.1, 2, work=(("vectorized_elementwise_kernel", 0.75),)),  # 20
    ]
    totals = {"copy_kernel_a": (1.0, 1), "implicit_gemm_conv_fprop": (5.0, 1), "flash_self_fwd_kernel": (3.0, 1),
              "copy_kernel_b": (0.5, 1), "vectorized_elementwise_kernel": (1.75, 2), "reduce_kernel": (0.25, 1),
              "dgrad_kernel": (4.0, 1), "wgrad_kernel": (2.0, 1), "copy_kernel_c": (0.125, 1),
              # two memsets the profiler tied to no op
              "Memset (Device)": (0.5, 2)}
    return ev, totals


def _row(joined, module, op, backward=False):
    hits = [r for r in joined["rows"] if (r["module"], r["op"], r["backward"]) == (module, op, backward)]
    assert len(hits) == 1, (module, op, backward, joined["rows"])
    return hits[0]


def test_join_attributes_modules_backward_and_sources():
    events, totals = _hand_built_events()
    joined = join(events, totals, _kinds())
    conv = _row(joined, "unet.down_blocks.0.resnets.0", "aten::convolution")
    assert (conv["family"], conv["kind"], conv["ms"], conv["launches"]) == ("conv", "ResnetBlock2D", 5.0e-3, 1)
    assert _row(joined, "unet.up_blocks.0", "aten::to")["family"] == "copy_cast"
    # the innermost module range, not its parent's
    assert _row(joined, "unet.down_blocks.0.resnets.0.norm1", "aten::copy_")["kind"] == "GroupNorm"
    direct = _row(joined, "unet.down_blocks.0.resnets.0.norm1", DIRECT)
    assert direct["family"] == "k1_flash_self_fwd"
    # the backward goes to the conv's module (the last op with seq 10 before it), not aten::to's
    bwd = _row(joined, "unet.down_blocks.0.resnets.0", "aten::convolution_backward", backward=True)
    assert (bwd["ms"], bwd["launches"]) == (6.0e-3, 2)
    src = "src: guidance/losses.py(47): compute_token_stats"
    assert _row(joined, src, "aten::mul")["launches"] == 1
    assert _row(joined, src, "aten::mul", backward=True)["ms"] == 0.75e-3
    assert _row(joined, UNATTRIBUTED, "aten::sum")["family"] == "reduce"
    assert _row(joined, "src: pipeline.py(285): guidance_eval", "aten::copy_")["ms"] == 0.125e-3
    unlinked = _row(joined, UNATTRIBUTED, NOT_LINKED)
    assert (unlinked["family"], unlinked["launches"], unlinked["ms"]) == ("other", 2, 0.5e-3)


def test_join_closes_and_says_when_it_does_not():
    events, totals = _hand_built_events()
    joined = join(events, totals, _kinds())
    assert joined["closes"]
    fams = joined["families"]
    assert sum(f["launches"] for f in fams.values()) == sum(n for _us, n in totals.values()) == 12
    assert sum(r["launches"] for r in joined["rows"]) == 12
    assert abs(sum(r["ms"] for r in joined["rows"]) - sum(us for us, _n in totals.values()) / 1e3) < 1e-12
    assert fams["other"]["unattributed_launches"] == 2 and fams["reduce"]["unattributed_ms"] == 0.25e-3
    # a kernel counted twice (the totals hold one) breaks the closure of its family
    events[5].work = (("implicit_gemm_conv_fprop", 5.0),)
    broken = join(events, totals, _kinds())
    assert not broken["closes"] and not broken["families"]["conv"]["closes"]
    assert broken["families"]["copy_cast"]["closes"]


def test_profile_drives_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port_profile.main(["--device", "cpu", "--model", "micro", "--steps", "2"]) == 0
    with open(os.path.join("chiprun_out", "profile_ops.json")) as f:
        table = json.load(f)
    s = table["summary"]
    assert s["join_closes"] and s["join_unit"] == "cpu op self ms" and s["device_kernel_ms"] is None
    assert s["n_evals_total"] > 0 and s["join_unattributed_ms"] >= 0
    assert table["join"]["closes"] and all(f["closes"] for f in table["join"]["families"].values())
    rows = table["join"]["rows"]
    assert any(r["module"].startswith("unet.") for r in rows)
    assert any(r["module"].startswith("src: ") for r in rows)  # the guidance losses are no module
    assert any(r["backward"] and r["module"].startswith("unet.") for r in rows)
    assert table["kinds"]["unet.down_blocks.0.resnets.0.norm1"] == "GroupNorm"
    capsys.readouterr()
    assert port_profile.main(["--analyze", os.path.join("chiprun_out", "profile_ops.json")]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed.splitlines()[0]) == s
    assert "[copy_cast]" in printed and "in full, by module kind" in printed


def test_perf_host_tail_drives_quick():
    row = perf_host_tail.main(["--quick", "--steps", "2", "--reps", "1"])
    assert (row["model"], row["device"], len(row["calls"])) == ("micro", "cpu", 2)
    assert row["dispatch_s"] > 0 and row["result_decode_s"] > 0
    assert row["split"] is None and row["rtt_floor_ms"] is None  # no device here


def test_perf_unet_eager_only_on_cpu(pair):
    _jsd, tsd = pair
    row = perf_unet.measure(tsd.unet, perf_unet.Variant(bwd=True), n=1, reps=1)
    assert row["mode"] == "eval" and row["batch"] == 1 and row["finite"]
    assert row["graph_ms_per_call"] is None and row["bitwise_equal"] is None and row["eager_ms_per_call"] > 0


def test_tools_default_to_cuda_and_do_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default device is usable")
    for main in (lambda: perf_unet.main(["--n", "1"]), lambda: port_profile.main([]),
                 lambda: perf_host_tail.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            main()
    with pytest.raises(ValueError, match="CUDA"):
        perf_host_tail.floors(torch.device("cpu"))


def test_flags_whose_route_is_not_taken_raise(pair):
    _jsd, tsd = pair
    with pytest.raises(ValueError, match="2048 queries"):  # micro's longest cross-attention has 256
        perf_unet.measure(tsd.unet, perf_unet.Variant(fused_cross=True), n=1, reps=1)
    with pytest.raises(ValueError, match="CUDA"):
        perf_unet.apply_variant(tsd.unet, perf_unet.Variant(bwd_block=64))
    with pytest.raises(ValueError, match="use_flash_attention=False"):
        perf_unet.apply_variant(tsd.unet, perf_unet.Variant(flash_all=True))
    # sd15's 32x32 and 16x16 self-attention have head dims 80 and 160, which K1/K2 do not take
    sd15 = types.SimpleNamespace(config=get_config("sd15").unet, conv_in=types.SimpleNamespace(weight=torch.empty(0)))
    with pytest.raises(ValueError, match=r"32x32 \(1024 queries, head_dim 80\), 16x16 \(256 queries, head_dim 160\)"):
        perf_unet.apply_variant(sd15, perf_unet.Variant(flash_all=True))
    with pytest.raises(ValueError, match="keys per block"):
        perf_unet.k2_config_for_block(96)
    assert perf_unet.k2_config_for_block(128) == 0 and perf_unet.k2_config_for_block(64) == 2
