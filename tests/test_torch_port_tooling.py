"""The port's microbench variants and FLOP accounting against the JAX package.

* The plain versions of V1 and W1 (what their wrappers run on CPU tensors,
  and what the kernels are held to on the card) against ``fwd_v1`` and
  ``bwd_w1`` of ``scripts/perf_attn_kernel.py``, run by the Pallas TPU
  interpreter, on the same bf16 inputs at [2, 256, D] for both head dims
  the kernels take, D = 40 and 64. Both sides round their output (and W1's
  P and dS) to bf16 at places that differ: the Pallas kernels take exp of a
  max-shifted fp32 score on the whole row, the plain versions do too but
  through other fp32 roundings, so a product input can land one bf16 ulp
  apart. Measured here, relative to max|ref|, at D = 40 (64): V1 out 4.2e-4
  (2.8e-3) with bf16_p 0 and 2.1e-4 (1.4e-3) with bf16_p 1, W1 dq 1.5e-3
  (3.8e-4), dk 3.4e-5 (8.3e-6), dv 3.6e-5 (5.7e-5). The limits, 2^-6 for
  the bf16 outputs and 2^-8 for the fp32 dk and dv, leave 5x or more.
* ``runtime/flops.py`` against the JAX package's for every preset.
* The wrappers' CPU contract: plain version for CPU tensors, no launch;
  and the tile tables the wrappers and the microbench name against the
  CUDA sources.
"""
import importlib.util
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from guided_attention_tpu.models.configs import get_config as jax_get_config
from guided_attention_tpu.runtime import flops as jflops

from guided_attention_tpu_torch import perf_attn_kernel, perf_batch
from guided_attention_tpu_torch.models.configs import get_config
from guided_attention_tpu_torch.ops import attention_variants as av
from guided_attention_tpu_torch.ops import flash_attention as fa
from guided_attention_tpu_torch.runtime import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 256, 40)
SCALE = 40**-0.5
HEAD_DIMS = (40, 64)  # the kernels' head dims: SD1.5, SD2.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tpu_bench():
    """scripts/perf_attn_kernel.py, imported by path. It sets
    JAX_COMPILATION_CACHE_DIR and prepends to sys.path when imported; both
    are put back afterwards."""
    env, path = os.environ.get("JAX_COMPILATION_CACHE_DIR"), list(sys.path)
    spec = importlib.util.spec_from_file_location("tpu_perf_attn_kernel", os.path.join(REPO, "scripts", "perf_attn_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    sys.path[:] = path
    if env is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = env


def _bf16_inputs(seed: int, count: int, shape=SHAPE):
    """``count`` float32 arrays from a numpy seed, and the same values as
    bf16 on both sides (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays], [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bf16_p", [False, True])
def test_v1_plain_matches_fwd_v1(tpu_bench, bf16_p, d):
    shape, scale = (2, 256, d), d**-0.5
    (jq, jk, jv), (q, k, v) = _bf16_inputs(3, 3, shape)
    with pltpu.force_tpu_interpret_mode():
        want = tpu_bench.fwd_v1(jq, jk, jv, scale, 128, bf16_p)
    got = av.flash_self_fwd_v1_plain(q, k, v, scale, bf16_p)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert _rel(got, want) <= 2.0**-6


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_w1_plain_matches_bwd_w1(tpu_bench, d):
    shape, scale = (2, 256, d), d**-0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _bf16_inputs(4, 4, shape)
    with pltpu.force_tpu_interpret_mode():
        want = tpu_bench.bwd_w1(jq, jk, jv, jdo, scale, 128)
    got = av.flash_self_bwd_w1_plain(q, k, v, do, scale)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for name, g, w, tol in zip(("dq", "dk", "dv"), got, want, (2.0**-6, 2.0**-8, 2.0**-8)):
        assert tuple(g.shape) == shape, name
        assert _rel(g, w) <= tol, name


@pytest.mark.parametrize("name", ["sd15", "sd21", "micro"])
def test_flops_match_jax(name):
    cfg, jcfg = get_config(name).unet, jax_get_config(name, jnp.float32).unet
    assert flops.unet_forward_flops(cfg) == pytest.approx(jflops.unet_forward_flops(jcfg), rel=1e-12)
    assert flops.unet_forward_flops(cfg, batch=2) == pytest.approx(jflops.unet_forward_flops(jcfg, batch=2), rel=1e-12)
    assert flops.unet_eval_flops(cfg, 16) == pytest.approx(jflops.unet_eval_flops(jcfg, 16), rel=1e-12)
    steps = 50
    n_evals = np.zeros(steps, np.int32)
    n_evals[[0, 3, 10]] = (36, 12, 4)
    recursions = np.ones(steps, np.int32)
    recursions[:14] = 3
    diags = types.SimpleNamespace(n_evals=n_evals, recursions=recursions)
    gen = flops.generation_flops(cfg, diags, steps)
    assert gen == pytest.approx(jflops.generation_flops(jcfg, diags, steps), rel=1e-12)
    assert gen > 2 * steps * flops.unet_forward_flops(cfg)


def test_mfu_and_bound_use_h100_peaks():
    assert flops.H100_BF16_PEAK_FLOPS == 989e12 and flops.H100_HBM_BYTES_PER_S == 3.35e12
    assert flops.mfu(989e12, 2.0) == pytest.approx(0.5)
    # K1 at [16, 4096, 40]: 4 * 16 * 4096^2 * 40 operations, 0.0434 ms
    ms, by = flops.bound_ms(perf_attn_kernel.fwd_flops(16, 4096, 40), 4 * 16 * 4096 * 40 * 2)
    assert by == "operations" and ms == pytest.approx(0.04342, rel=1e-3)
    ms, by = flops.bound_ms(1e6, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)


# (work, expected bound in ms, bound_by): K1 at the CFG shape [16, 4096, 40],
# K2 at the eval shape [8, 4096, 40] (one exponential per pair), K3's shape
BOUND_CASES = {
    "k1_fwd": ((4 * 16 * 4096**2 * 40, 4 * 16 * 4096 * 40 * 2 + 16 * 4096 * 4, 16 * 4096**2), 0.0688, "exp"),
    "k2_bwd": ((10 * 8 * 4096**2 * 40, 8 * 8 * 4096 * 40 * 2 + 8 * 4096 * 4, 8 * 4096**2), 0.0543, "operations"),
    "k3": ((4 * 8 * 256 * 77 * 160, (2 * 8 * 256 * 160 + 2 * 8 * 77 * 160) * 2 + 256 * 77 * 4, 8 * 256 * 77),
           0.000532, "bytes"),
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bound_counts_exponentials(case):
    """16 exp2 per SM per clock over 132 SMs at ~1.83 GHz: at head dim 40
    the forward's exponentials take longer than its products."""
    assert flops.H100_EXP2_PER_S == 3.9e12
    (ops, nbytes, exps), want_ms, want_by = BOUND_CASES[case]
    ms, by = flops.bound_ms(ops, nbytes, exps=exps)
    assert by == want_by and ms == pytest.approx(want_ms, rel=2e-3)


def test_k1_tile_configs_match_the_source():
    """``K1_TILE_CONFIGS`` and ``K1_MAIN_CONFIG`` name the configurations
    csrc/flash_self_fwd.cu instantiates, in its index order."""
    src = open(os.path.join(REPO, "guided_attention_tpu_torch", "csrc", "flash_self_fwd.cu")).read()
    launches = re.findall(r"launch<(\d+), (\d+), (\d+), \d+, DK>", src)
    assert tuple((64 * int(cw), int(bk), int(st)) for cw, bk, st in launches) == fa.K1_TILE_CONFIGS
    assert int(re.search(r"kMainConfig = (\d+);", src).group(1)) == fa.K1_MAIN_CONFIG
    assert [perf_attn_kernel.k1_tiles_name(c) for c in range(3)] == [
        "K1 c0 (128,128,3)", "K1 c1 (128,64,3)", "K1 c2 (64,128,2)"]


def test_k2_tile_configs_match_the_source():
    """``K2_TILE_CONFIGS`` and ``K2_MAIN_CONFIG`` name the configurations
    csrc/flash_self_bwd.cu instantiates, in its index order: (keys per
    block, queries per tile, stages) of the dK/dV pass, (queries per block,
    keys per tile, stages) of the dQ pass."""
    src = open(os.path.join(REPO, "guided_attention_tpu_torch", "csrc", "flash_self_bwd.cu")).read()
    tiles = r"Tiles<(\d+), (\d+), (\d+), \d+>"
    launches = re.findall(rf"launch<{tiles}, {tiles}, DK>", src)
    assert tuple(((64 * int(a), int(b), int(c)), (64 * int(e), int(f), int(g)))
                 for a, b, c, e, f, g in launches) == fa.K2_TILE_CONFIGS
    assert int(re.search(r"kMainConfig = (\d+);", src).group(1)) == fa.K2_MAIN_CONFIG
    assert [perf_attn_kernel.k2_tiles_name(c) for c in range(3)] == [
        "K2 c0 (128,64,4|128,64,4)", "K2 c1 (128,64,2|128,64,2)", "K2 c2 (64,64,4|64,64,4)"]


def test_v1_tile_configs_match_the_source():
    """``V1_CONFIGS`` and ``V1_MAIN_CONFIG`` name the configurations
    csrc/flash_self_fwd_v1.cu instantiates, in its index order."""
    src = open(os.path.join(REPO, "guided_attention_tpu_torch", "csrc", "flash_self_fwd_v1.cu")).read()
    launches = re.findall(r"launch<(\d+), (\d+), (\d+), \d+, DK, BF16_P>", src)
    assert tuple((64 * int(cw), int(bk), int(st)) for cw, bk, st in launches) == av.V1_CONFIGS
    assert tuple(map(int, re.search(r"kMainConfig\[2\] = \{(\d+), (\d+)\};", src).groups())) == av.V1_MAIN_CONFIG
    assert [perf_attn_kernel.v1_tiles_name(c, bp) for c in range(3) for bp in (0, 1)] == [
        "V1 c0 (128,128,3) bf16_p=0", "V1 c0 (128,128,3) bf16_p=1", "V1 c1 (128,64,3) bf16_p=0",
        "V1 c1 (128,64,3) bf16_p=1", "V1 c2 (64,128,2) bf16_p=0", "V1 c2 (64,128,2) bf16_p=1"]


def test_w1_tile_configs_match_the_source():
    """``W1_CONFIGS`` and ``W1_MAIN_CONFIG`` name the configurations
    csrc/flash_self_bwd_w1.cu instantiates, in its index order: (keys per
    block, queries per tile, stages) of the dK/dV pass, (queries per block,
    keys per tile, stages) of the statistics-and-dQ pass."""
    src = open(os.path.join(REPO, "guided_attention_tpu_torch", "csrc", "flash_self_bwd_w1.cu")).read()
    tiles = r"Tiles<(\d+), (\d+), (\d+), \d+>"
    launches = re.findall(rf"launch<{tiles}, {tiles}, DK>", src)
    assert tuple(((64 * int(a), int(b), int(c)), (64 * int(e), int(f), int(g)))
                 for a, b, c, e, f, g in launches) == av.W1_CONFIGS
    assert int(re.search(r"kMainConfig = (\d+);", src).group(1)) == av.W1_MAIN_CONFIG
    assert [perf_attn_kernel.w1_tiles_name(c) for c in range(3)] == [
        "W1 c0 (128,64,4|128,64,4)", "W1 c1 (128,64,2|128,64,2)", "W1 c2 (64,64,4|64,64,4)"]


def test_variant_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the V1 and W1 wrappers, main and tile-sweep entries,
    run their plain versions and count no launch; bf16 in, as on the card,
    at both head dims."""
    fa.reset_launches()
    for d in HEAD_DIMS:
        scale = d**-0.5
        _, (q, k, v, do) = _bf16_inputs(5, 4, (2, 64, d))
        for bp in (False, True):
            want = av.flash_self_fwd_v1_plain(q, k, v, scale, bp)
            torch.testing.assert_close(av.flash_self_fwd_v1(q, k, v, scale, bp), want, rtol=0, atol=0)
            for c in range(len(av.V1_CONFIGS)):
                torch.testing.assert_close(av.flash_self_fwd_v1_config(q, k, v, scale, bp, c), want, rtol=0, atol=0)
        want = av.flash_self_bwd_w1_plain(q, k, v, do, scale)
        for a, b in zip(av.flash_self_bwd_w1(q, k, v, do, scale), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for c in range(len(av.W1_CONFIGS)):
            for a, b in zip(av.flash_self_bwd_w1_config(q, k, v, do, scale, c), want):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(n == 0 for n in fa.LAUNCHES.values())


def test_variant_wrappers_refuse_other_shapes():
    x = torch.zeros(2, 64, 48, dtype=torch.bfloat16)  # a head dim no kernel is built for
    with pytest.raises(ValueError, match="head_dim"):
        av.flash_self_fwd_v1(x, x, x, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        av.flash_self_bwd_w1(x, x, x, x, 0.125)
    y = torch.zeros(2, 64, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shapes"):
        av.flash_self_fwd_v1(y, y[:, :32], y, 0.125)


def test_microbench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        perf_attn_kernel.run(reps=1)


def test_perf_batch_drives_on_cpu(tmp_path):
    """``python -m guided_attention_tpu_torch.perf_batch`` at micro on the
    CPU, batch 2 of the two batch prompts, 2 steps: a warm-up and one timed
    batch, its row printed and written; the device metrics read as not
    measured."""
    out = tmp_path / "perf_batch.json"
    rows = perf_batch.main(["--device", "cpu", "--model", "micro", "--steps", "2", "--reps", "1", "--multi",
                            "--out", str(out), "2"])
    (row,) = rows
    assert (row["batch"], row["multi_prompt"], row["steps"], len(row["walls_s"])) == (2, True, 2, 1)
    assert row["s_per_image"] == pytest.approx(row["s_per_batch"] / 2)
    assert row["mfu"] is None and row["peak_mem_gib"] is None and row["card"] == "cpu"
    assert row["unet_tflop_per_batch"] > 0 and all(n > 0 for n in row["n_evals_per_sample"])
    assert json.loads(out.read_text().splitlines()[0]) == row
