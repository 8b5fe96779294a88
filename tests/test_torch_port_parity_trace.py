"""The port's parity tracer (``guided_attention_tpu_torch/parity_trace.py``)
against the JAX package's (``scripts/parity_trace.py``), and the port's bf16
dtype flow against the JAX package's.

The tracer: the latent layouts, the thresholds parser, the schema, compare's
pass/fail and masking (as ``tests/test_parity_trace.py`` holds the JAX
tool), and the two tools on one micro run: the JAX tool traces the JAX
micro bundle (``torch_port_helpers.jax_micro_bundle``, handed to it in place
of ``StableDiffusion.create``) and writes the initial latent; the port's
command line traces the same weights (a native checkpoint written by the
port, ``--checkpoint``) from that latent in the other layout. ``recurse_steps``
is 1 on both sides, so that no re-noise draw enters (the two packages draw
from different generators), and the threshold 0.0 is never met, so that both
take the same branches: ten refinement iterations and the final eval at step
0. Each tool's compare must pass the other's file at the default tolerances
(1e-3 relative, 1e-4 absolute; eval_maps 5e-3 / 1e-3); the files differ by
float32 rounding, about 1e-6.

bf16 (ROADMAP Queue 3 item 1): at micro, with the same float32 weights, the
distance of the port's bf16 results from its float32 results must stay
within ``BF16_FACTOR`` (1.25) of the JAX package's own bf16-vs-float32
distance (jitted, as its pipeline runs), for one CLIP forward, and for
guidance evals: their loss, latent gradient and UNet eps. Distances are
relative rms over ``EVAL_LATENTS`` latents. These evals read one shared text
embedding (float32 CLIP's, rounded to bf16), so that they hold the UNet and
the guidance loss alone. The whole bf16 flow, each package's own bf16 CLIP
feeding its own bf16 eval, is held over ``OWN_PROMPTS`` prompts of one token
layout: each package rounds the embedding its own way (the two bf16
embeddings lie 9e-3 apart, each 8e-3 from float32), and that one rounding
draw moves every eval of a prompt alike, so the distance of one prompt is
one sample. The median over the prompts of the port's distance over the JAX
package's must stay within ``BF16_FACTOR``. Measured: the loss's ratio is
0.21-1.83 by prompt (1.83 for the meta-prompt's "robot and vase"), median
0.76; the gradient's 0.60-1.06, median 0.90.
"""
import json
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.guidance.losses import compute_loss as j_compute_loss
from guided_attention_tpu.guidance.losses import compute_token_stats as j_compute_token_stats
from guided_attention_tpu.guidance.spec import build_guidance_spec as j_build_spec
from guided_attention_tpu.annotation import parse_prompt as j_parse_prompt
from guided_attention_tpu.models import bundle as jbundle
from guided_attention_tpu.models.configs import get_config as j_get_config
from guided_attention_tpu.pipeline import aggregate_cross_maps as j_aggregate

from guided_attention_tpu_torch import parity_trace as tpt
from guided_attention_tpu_torch.guidance.spec import stack_specs
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.io import save_params
from guided_attention_tpu_torch.pipeline import _Loop
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe
from guided_attention_tpu_torch.runner import PrepareOptions

from torch_port_helpers import jax_micro_bundle

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))
import parity_trace as jpt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED, STEPS = 28, 3
TRACE_ARGS = ["--model", "micro", "--steps", str(STEPS), "--seed", str(SEED), "--thresholds", "0:0.0",
              "--hp", json.dumps({"recurse_steps": 1})]
BF16_FACTOR = 1.25
EVAL_LATENTS = 8
OWN_LATENTS = 4
# "a X and a Y" with X and Y one token each: the tokens of META's spec (2 and
# 5) keep their places, so every prompt's eval reads META's spec
OWN_PROMPTS = tuple(f"a {x} and a {y}" for x, y in (
    ("robot", "vase"), ("cat", "sofa"), ("dog", "ball"), ("car", "tree"), ("man", "horse"), ("bird", "house"),
    ("boat", "moon"), ("girl", "chair"), ("apple", "table"), ("lamp", "book"), ("fish", "bowl"), ("clock", "wall")))
META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"


@pytest.fixture(scope="module")
def jsd():
    return jax_micro_bundle()


@pytest.fixture(scope="module")
def tsd(jsd):
    sd = TSD.create("micro", torch.float32, device="cpu")
    sd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return sd


@pytest.fixture(scope="module")
def files(jsd, tsd, tmp_path_factory):
    """The JAX tool's trace, the initial latent it used, and the port
    command line's trace of the same weights from that latent (NCHW)."""
    d = tmp_path_factory.mktemp("ptrace")
    f = {k: str(d / n) for k, n in (("jax", "jax.npz"), ("torch", "torch.npz"), ("init", "init_nhwc.npy"),
                                    ("init_nchw", "init_nchw.npy"), ("ckpt", "ckpt"))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbundle.StableDiffusion, "create", lambda *a, **k: jsd)
        assert jpt.main(["trace", *TRACE_ARGS, "--cpu", "--out", f["jax"], "--save_latents", f["init"]]) == 0
    np.save(f["init_nchw"], np.load(f["init"]).transpose(0, 3, 1, 2))
    save_params(f["ckpt"], tsd)
    assert tpt.main(["trace", *TRACE_ARGS, "--cpu", "--checkpoint", f["ckpt"], "--latents", f["init_nchw"],
                     "--out", f["torch"]]) == 0
    return f


def test_norm_latents_layouts():
    nhwc = np.random.default_rng(0).normal(size=(1, 8, 8, 4)).astype(np.float32)
    nchw = np.transpose(nhwc, (0, 3, 1, 2))
    assert np.array_equal(tpt.norm_latents(nhwc), nhwc)
    assert np.array_equal(tpt.norm_latents(nchw), nhwc)
    with pytest.raises(ValueError):
        tpt.norm_latents(np.zeros((1, 3, 8, 8), np.float32))
    with pytest.raises(ValueError):
        tpt.norm_latents(np.zeros((2, 4, 8, 8), np.float32))


def test_parse_thresholds():
    assert tpt.parse_thresholds("") is None
    assert tpt.parse_thresholds("0:1.0") == {0: 1.0}
    assert tpt.parse_thresholds("0:0.1,3:0.8") == {0: 0.1, 3: 0.8}
    for s in ("", "0:1.0", "0:0.1,3:0.8"):
        assert tpt.parse_thresholds(s) == jpt.parse_thresholds(s)


def test_trace_schema_matches_the_jax_tools(files):
    t, j = np.load(files["torch"]), np.load(files["jax"])
    assert set(t.files) == set(j.files)
    for key in set(t.files) - {"meta"}:  # meta is a JSON string of its own length
        assert t[key].shape == j[key].shape and t[key].dtype == j[key].dtype, key
    meta = json.loads(str(t["meta"]))
    assert meta["side"] == "torch" and json.loads(str(j["meta"]))["side"] == "jax"
    assert (meta["device"], meta["dtype"], meta["attention"], meta["steps"]) == ("cpu", "fp32", "plain", STEPS)
    # the kernel wrappers run their plain versions on CPU tensors: no launch
    assert meta["launches"]["flash_self_fwd"] == 0 and set(meta["launches"].values()) == {0}
    assert set(json.loads(str(j["meta"]))) <= set(meta)
    S, R_sub = STEPS, t["eval_mask"].shape[1]
    assert t["total_loss"].shape == (S,) and t["eval_unscaled"].shape == (S, R_sub, 77)
    assert t["eval_maps"].shape == (S, R_sub, 16, 16, 77) and t["eval_maps"].dtype == np.float16
    assert t["latent_mean"].shape == (S, 4) and t["final_latents"].shape == (16, 16, 4)
    # step 0 never meets its threshold: eval0, ten refinements and the final eval
    assert t["eval_mask"][0].sum() == R_sub == 12 and not t["eval_mask"][1:].any()
    m = t["eval_maps"][0, 0].astype(np.float32)
    assert np.all(m >= 0) and abs(float(m.sum(-1).mean()) - 1.0) < 1e-2
    np.testing.assert_array_equal(t["init_latents"], np.load(files["init"])[0])


def test_port_trace_matches_the_jax_trace(files, capsys):
    rows = {}
    assert tpt.compare(files["jax"], files["torch"], rows=rows)
    assert "PARITY: PASS" in capsys.readouterr().out
    assert set(rows) == set(tpt.COMPARE_KEYS)
    assert rows["eval_unscaled"]["n"] == 12 * 77 and rows["final_latents"]["max_abs"] > 0


def test_each_tools_compare_reads_the_others_file(files, capsys):
    assert jpt.main(["compare", files["jax"], files["torch"]]) == 0
    assert jpt.main(["compare", files["torch"], files["jax"]]) == 0
    assert jpt.main(["compare", files["torch"], files["torch"], "--rtol", "0", "--atol", "0"]) == 0
    assert tpt.main(["compare", files["torch"], files["jax"]]) == 0
    assert tpt.main(["compare", files["jax"], files["jax"], "--rtol", "0", "--atol", "0"]) == 0
    assert capsys.readouterr().out.count("PARITY: PASS") == 5


def test_python_entry_equals_the_command_line(files, tsd):
    """``trace(pipe, ...)`` of the bundle in memory is bitwise the command
    line's trace of its native checkpoint."""
    fields = tpt.trace(TPipe(tsd), seed=SEED, steps=STEPS, latents=np.load(files["init"]), thresholds="0:0.0",
                       hp={"recurse_steps": 1}, model="micro")
    t = np.load(files["torch"])
    for key in tpt.COMPARE_KEYS + ("eval_mask",):
        np.testing.assert_array_equal(fields[key], t[key], err_msg=key)
    assert json.loads(fields["meta"]) == json.loads(str(t["meta"]))


def test_compare_self_bitexact_and_tamper_fails(files, tmp_path, capsys):
    assert tpt.main(["compare", files["torch"], files["torch"], "--rtol", "0", "--atol", "0"]) == 0
    assert "PARITY: PASS" in capsys.readouterr().out
    f = dict(np.load(files["torch"]))
    f["total_loss"] = f["total_loss"] + 0.1
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **f)
    assert tpt.main(["compare", files["torch"], bad, "--rtol", "1e-3", "--atol", "1e-4"]) == 1
    out = capsys.readouterr().out
    assert "FAIL total_loss" in out and "PARITY: FAIL" in out
    # eval_maps keep their looser floor only at the default tolerances
    assert tpt.key_tolerances("eval_maps") == (5e-3, 1e-3) == jpt._key_tolerances(
        "eval_maps", type("A", (), {"rtol": None, "atol": None})())
    assert tpt.key_tolerances("eval_maps", 1e-3, None) == (1e-3, 1e-4)


def test_compare_reads_only_the_joint_slots(files, tmp_path, capsys):
    """Values in slots that did not run in one file are not compared; a
    differing eval mask (diverged control flow) fails."""
    f = dict(np.load(files["torch"]))
    g = dict(f)
    g["eval_unscaled"] = f["eval_unscaled"].copy()
    g["eval_unscaled"][1:] = 123.0  # steps 1-2 ran no eval: not compared
    masked = str(tmp_path / "masked.npz")
    np.savez(masked, **g)
    assert tpt.main(["compare", files["torch"], masked, "--rtol", "0", "--atol", "0"]) == 0
    g["eval_mask"] = f["eval_mask"].copy()
    g["eval_mask"][0, -1] = False  # the final eval "did not run" in one file
    g["eval_unscaled"][0, -1] = 123.0
    diverged = str(tmp_path / "diverged.npz")
    np.savez(diverged, **g)
    assert tpt.main(["compare", files["torch"], diverged, "--rtol", "0", "--atol", "0"]) == 1
    out = capsys.readouterr().out
    assert "eval_mask DIFFERS" in out and "OK  eval_unscaled" in out.split("PARITY")[-2]
    assert jpt.main(["compare", files["torch"], diverged, "--rtol", "0", "--atol", "0"]) == 1


def test_trace_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tpt.main(["trace", "--model", "micro", "--steps", "1", "--out", str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")


# ---- bf16 against float32, the port's distance against the JAX package's


def _rms_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.sum((a - b) ** 2) / np.sum(b**2)))


@pytest.fixture(scope="module")
def bf16_bundles(jsd):
    """Both packages' micro bundles in bfloat16 with ``jsd``'s float32 weights."""
    j16 = jax_micro_bundle(cfg=j_get_config("micro", jnp.bfloat16))
    t16 = TSD.create("micro", torch.bfloat16, device="cpu")
    t16.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return j16, t16


def _jax_clip(j, ids):
    return np.asarray(j.text_encoder.apply({"params": j.params["text_encoder"]}, jnp.asarray(ids, jnp.int32)),
                      np.float32)


def _port_clip(t, ids):
    with torch.no_grad():
        return t.text_encoder(torch.from_numpy(ids)).float().numpy()


def _latents(n: int) -> np.ndarray:
    return np.random.default_rng(11).standard_normal((n, 1, 16, 16, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def bf16_runs(jsd, tsd, bf16_bundles):
    """Both packages' micro bundles in float32 and in bfloat16, with the same
    float32 weights, on the same inputs: the CLIP states of two prompts, and
    ``EVAL_LATENTS`` guidance evals (loss, latent gradient and eps of the
    eval's forward) given one shared bf16-exact text embedding."""
    j16, t16 = bf16_bundles
    lats = _latents(EVAL_LATENTS)
    ids = np.stack([tsd.tokenize(p)[0].numpy() for p in (META, "a cat on a red sofa")])
    # the text embedding each eval reads: float32 CLIP's, rounded to bf16,
    # so that both packages' evals start from the same numbers
    cond = torch.from_numpy(np.array(jsd.encode_prompt(META)[1:2], np.float32)).to(torch.bfloat16).float().numpy()
    out = {}
    for name, j, t in (("fp32", jsd, tsd), ("bf16", j16, t16)):
        jev = [_jax_eval(j, x, cond) for x in lats]
        tev = [_port_eval(t, x, cond) for x in lats]
        out[name] = {"jax": (_jax_clip(j, ids), *map(np.stack, zip(*jev))),
                     "port": (_port_clip(t, ids), *map(np.stack, zip(*tev)))}
    return out  # [dtype][side] = (clip, loss, grad, eps)


@pytest.fixture(scope="module")
def own_embedding_ratios(jsd, tsd, bf16_bundles):
    """For each of ``OWN_PROMPTS``: each package's own CLIP embedding of the
    prompt feeds its own evals of ``OWN_LATENTS`` latents, in float32 and in
    bfloat16; the port's bf16-vs-float32 distance over the JAX package's,
    of the loss and of the latent gradient."""
    j16, t16 = bf16_bundles
    lats = _latents(OWN_LATENTS)
    ratios = {"loss": [], "grad": []}
    for prompt in OWN_PROMPTS:
        ids = tsd.tokenize(prompt)[0].numpy()[None]
        runs = {}
        for name, j, t in (("fp32", jsd, tsd), ("bf16", j16, t16)):
            cj, ct = _jax_clip(j, ids), _port_clip(t, ids)
            runs[name] = {"jax": [np.stack(v) for v in zip(*(_jax_eval(j, x, cj)[:2] for x in lats))],
                          "port": [np.stack(v) for v in zip(*(_port_eval(t, x, ct)[:2] for x in lats))]}
        for i, what in enumerate(("loss", "grad")):
            d = {side: _rms_rel(runs["bf16"][side][i], runs["fp32"][side][i]) for side in ("jax", "port")}
            assert 0 < d["jax"] < 0.1, (prompt, what, d)
            ratios[what].append(d["port"] / d["jax"])
    return ratios


EVAL_T = 801


def _jax_eval(j, lat, cond):
    """Loss, latent gradient and eps of one guidance eval (the JAX package's
    loss_fn, guided_attention_tpu/pipeline.py:287-300, normal mode)."""
    hp = JHP()
    prompt, anns, custom = j_parse_prompt(META)
    spec = j_build_spec(j.tokenizer, prompt, anns, hp, custom, attention_res=16)
    dtype = j.config.unet.dtype

    def loss_fn(v, params, ctx):
        eps, aux = j.unet.apply({"params": params}, v, EVAL_T, ctx, capture=frozenset({("cross", 16)}))
        stats = j_compute_token_stats(j_aggregate(aux["maps"], 16), spec, hp)
        return j_compute_loss(stats, spec, hp)[0], eps

    fn = _JAX_EVALS.setdefault(dtype, jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))
    (loss, eps), grad = fn(jnp.asarray(lat, dtype), j.params["unet"], jnp.asarray(cond, dtype))
    return float(loss), np.asarray(grad, np.float32), np.asarray(eps, np.float32)


_JAX_EVALS = {}


def _port_eval(t_sd, lat, cond):
    """The same eval through the port's own path (``_Loop.guidance_eval``),
    and eps of the same forward."""
    pipe = TPipe(t_sd)
    hp, _p, _a, spec, statics, sched, arrays, emb = pipe._prepare(PrepareOptions(meta_prompt=META))
    dtype = t_sd.config.unet.dtype
    ctx = torch.from_numpy(cond).to(dtype)
    emb = torch.cat([emb[:1], ctx])
    loop = _Loop(t_sd, statics, hp, emb[None], stack_specs([spec]), sched, arrays, None, ("up", "down", "mid"))
    x = torch.from_numpy(lat).to(dtype)
    loss, _aux, grad = loop.guidance_eval(x, [0], EVAL_T, 0.0, x)
    with torch.no_grad():
        eps = t_sd.unet(x, EVAL_T, ctx)[0]
    return float(loss[0]), grad.float().numpy(), eps.float().numpy()


def test_bf16_float32_runs_of_the_two_packages_agree(bf16_runs):
    j, t = bf16_runs["fp32"]["jax"], bf16_runs["fp32"]["port"]
    for what, a, b in zip(("clip", "loss", "grad", "eps"), t, j):
        assert _rms_rel(a, b) < 1e-5, what
    assert np.isfinite(t[2]).all() and np.abs(t[2]).max() > 0


@pytest.mark.parametrize("what", ["clip", "loss", "grad", "eps"])
def test_bf16_distance_within_the_jax_distance(bf16_runs, what):
    """One CLIP forward (two prompts), the guidance evals' loss and latent
    gradient, and the UNet forward's eps: the port's bf16 distance from its
    float32 result within BF16_FACTOR of the JAX package's."""
    i = ("clip", "loss", "grad", "eps").index(what)
    d_jax = _rms_rel(bf16_runs["bf16"]["jax"][i], bf16_runs["fp32"]["jax"][i])
    d_port = _rms_rel(bf16_runs["bf16"]["port"][i], bf16_runs["fp32"]["port"][i])
    assert 0 < d_jax < 0.1, d_jax
    assert d_port <= BF16_FACTOR * d_jax, (d_port, d_jax)


@pytest.mark.parametrize("what", ["loss", "grad"])
def test_bf16_own_embedding_distance_within_the_jax_distance(own_embedding_ratios, what):
    """The whole bf16 flow, each package's CLIP feeding its guidance evals:
    the median over ``OWN_PROMPTS`` of the port's bf16 distance over the JAX
    package's within BF16_FACTOR (one prompt's ratio is one rounding draw of
    its embedding)."""
    r = np.array(own_embedding_ratios[what])
    assert len(r) == len(OWN_PROMPTS) and np.isfinite(r).all(), r
    assert float(np.median(r)) <= BF16_FACTOR, r
