"""SD2.1 in the port against the JAX package: what SD2.1 adds to SD1.5.

SD2.1-base differs from SD1.5 in three places on the guided path: its UNet's
Transformer2D blocks project with Linear layers on the tokens
(``use_linear_projection``) and carry per-block head counts at head dim 64,
its CLIP uses the exact-erf ``gelu``, and its guidance spec normalizes over
the prompt's tokens up to the end-of-text token (``normalize_eot``, set from
``sd_2_1``). A micro variant with all three (``micro_sd21``: the micro
config with ``use_linear_projection=True``, heads (1, 2, 2, 2) as in
``tests/test_models_parity.py``, CLIP ``hidden_act="gelu"``) goes through
both packages at float32 with the same weights (``params_from_jax``) and
inputs.

Tolerances: the UNet's eps, the bottleneck and the CLIP states within 1e-4
absolute (outputs of size O(1)-O(10) through a dozen float32 layers, sums in
another order); maps within 1e-5 (probabilities). The guided generation
(``sd_2_1=True``, three steps, a threshold of 0.0 at step 0, never met: ten
refinements, the final eval and three recursions with JAX's own re-noise
draws handed to the port) goes through the port's ``parity_trace.trace`` and
the JAX package's ``scripts/parity_trace.py`` (handed the JAX micro_sd21
bundle), and the port's compare must pass the two files at its default
tolerances (1e-3 relative, 1e-4 absolute; eval_maps 5e-3 / 1e-3).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from guided_attention_tpu import annotation as jann
from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.guidance.spec import build_guidance_spec as jbuild
from guided_attention_tpu.models import bundle as jbundle
from guided_attention_tpu.models import configs as jconfigs
from guided_attention_tpu.models.tokenizer import SimpleTokenizer as JTok
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe

from guided_attention_tpu_torch import annotation as tann
from guided_attention_tpu_torch import parity_trace as tpt
from guided_attention_tpu_torch import workload
from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.frontends import cli as tcli
from guided_attention_tpu_torch.guidance.spec import build_guidance_spec as tbuild
from guided_attention_tpu_torch.models import configs as tconfigs
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models.convert import params_from_jax
from guided_attention_tpu_torch.models.tokenizer import SimpleTokenizer as TTok
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe
from guided_attention_tpu_torch.runner import PrepareOptions

from torch_port_helpers import jax_draws, jax_micro_bundle

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


ATOL = 1e-4
META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
SEED, STEPS = 5, 3
TRACE_KW = dict(meta_prompt=META, seed=SEED, steps=STEPS, thresholds="0:0.0", sd_2_1=True)


def _micro_sd21(configs, dtype):
    """The micro config with SD2.1's three differences."""
    base = configs.micro_config(dtype)
    return dataclasses.replace(
        base,
        name="micro_sd21",
        unet=dataclasses.replace(base.unet, num_heads=(1, 2, 2, 2), use_linear_projection=True),
        clip=dataclasses.replace(base.clip, hidden_act="gelu"),
    )


@pytest.fixture(scope="module")
def pair():
    jsd = jax_micro_bundle(cfg=_micro_sd21(jconfigs, jnp.float32))
    tsd = TSD.from_config(_micro_sd21(tconfigs, torch.float32), device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return jsd, tsd


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {
        "lat": rng.standard_normal((1, 16, 16, 4)).astype(np.float32),
        "ctx": rng.standard_normal((1, 77, 64)).astype(np.float32),
    }


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_sd21_preset_equals_the_jax_preset():
    """Every field of the port's sd21 config equals the JAX package's but the
    dtypes, which are each package's own type; the JAX UNet's one more field
    is its Pallas backward's tile (``flash_bwd_block``)."""
    t, j = tconfigs.get_config("sd21"), jconfigs.get_config("sd21")
    assert (t.name, t.latent_size, t.image_size) == (j.name, j.latent_size, j.image_size) == ("sd21", 64, 512)
    for part in ("unet", "clip", "vae"):
        tf, jf = dataclasses.asdict(getattr(t, part)), dataclasses.asdict(getattr(j, part))
        assert set(tf) == set(jf) - {"flash_bwd_block"}, part
        for k in tf:
            if "dtype" not in k:
                assert tf[k] == jf[k], (part, k)
    assert t.unet.num_heads == (5, 10, 20, 20) and t.unet.cross_attention_dim == 1024
    assert {c // h for c, h in zip(t.unet.block_out_channels, t.unet.num_heads)} == {64}
    assert t.unet.use_linear_projection and t.unet.use_flash_attention
    assert (t.clip.hidden_size, t.clip.num_layers, t.clip.num_heads, t.clip.hidden_act) == (1024, 23, 16, "gelu")


def test_params_from_jax_carries_the_linear_projections(pair):
    jsd, tsd = pair
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jsd.params["unet"]), tsd.unet, "unet")
    assert set(sd) == set(tsd.unet.state_dict())
    t2d = tsd.unet.down_blocks[0].attentions[0]
    assert isinstance(t2d.proj_in, torch.nn.Linear) and isinstance(t2d.proj_out, torch.nn.Linear)
    for name in ("proj_in", "proj_out"):
        k = np.asarray(jsd.params["unet"]["down_blocks_0_attentions_0"][name]["kernel"])  # Dense [in, out]
        assert k.ndim == 2
        np.testing.assert_array_equal(getattr(t2d, name).weight.numpy(), k.T)
    assert t2d.transformer_blocks[0].attn1.heads == 1 and tsd.unet.mid_block.attentions[0].transformer_blocks[0].attn1.heads == 2


@pytest.mark.parametrize("case", ["plain", "capture"])
def test_unet_matches_jax(pair, inputs, case):
    jsd, tsd = pair
    capture = frozenset({("cross", 16), ("self", 8), ("cross_perhead", 4)}) if case == "capture" else frozenset()
    # jitted: XLA:CPU compiles the forward in a few seconds; eager dispatch
    # of its ops takes longer
    apply = jax.jit(jsd.unet.apply, static_argnames=("capture",))
    je, jaux = apply({"params": jsd.params["unet"]}, jnp.asarray(inputs["lat"]), 500, jnp.asarray(inputs["ctx"]),
                     capture=capture)
    with torch.no_grad():
        te, taux = tsd.unet(torch.from_numpy(inputs["lat"]), 500, torch.from_numpy(inputs["ctx"]), capture=capture)
    _close(te, je)
    _close(taux["deep"], jaux["deep"])
    for key, jl in jaux["maps"].items():
        tl = taux["maps"][key]
        assert len(tl) == len(jl), key
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == tuple(b.shape), key
            _close(a, b, 1e-5)
    # 16x16: down_blocks_0 and up_blocks_3 (1 + 2 layers), 8x8 and 4x4 likewise
    assert sum(len(v) for v in taux["maps"].values()) == (9 if case == "capture" else 0)


def test_clip_gelu_matches_jax(pair):
    jsd, tsd = pair
    ids = np.random.default_rng(2).integers(0, 49408, size=(2, 77))
    jh = jsd.text_encoder.apply({"params": jsd.params["text_encoder"]}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        th = tsd.text_encoder(torch.from_numpy(ids))
    _close(th, jh)
    _close(tsd.encode_prompt("a robot and a vase"), jsd.encode_prompt("a robot and a vase"))
    # the exact erf, not the tanh form: the two differ by up to 5e-4 at |x| ~ 2
    from guided_attention_tpu_torch.models.clip import CLIPMLP

    mlp = CLIPMLP(dataclasses.replace(tsd.text_encoder.config, hidden_size=1, intermediate_size=1)).double()
    x = torch.linspace(-4, 4, 801, dtype=torch.float64)
    with torch.no_grad():
        for fc in (mlp.fc1, mlp.fc2):
            fc.weight.fill_(1.0)
            fc.bias.zero_()
        got = mlp(x[:, None])[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)),
                               rtol=0, atol=1e-6)
    assert float((got - torch.nn.functional.gelu(x, approximate="tanh")).abs().max()) > 1e-4


@pytest.mark.parametrize("normalize_eot", [False, True])
@pytest.mark.parametrize("meta", [META, "a [cat:.2,.4] next to a [dog:.7,.5,.2,.3] and a tree"])
def test_normalize_eot_spec_matches_jax(meta, normalize_eot):
    jp, ja, jc = jann.parse_prompt(meta)
    tp, ta, tc = tann.parse_prompt(meta)
    js = jbuild(JTok(), jp, ja, JHP(), jc, attention_res=16, normalize_eot=normalize_eot)
    ts = tbuild(TTok(), tp, ta, THP(), tc, attention_res=16, normalize_eot=normalize_eot, device="cpu")
    for f in ("token_mask", "valid_text", "inside_mask", "w_in", "w_out", "at_most", "subprompt_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    n_ids = len(TTok().encode(tp))  # BOS, the words, EOS
    want = np.zeros(77, bool)
    want[1 : (n_ids - 1 if normalize_eot else 76)] = True
    np.testing.assert_array_equal(ts.valid_text.numpy(), want)


def test_runner_normalizes_the_eot_under_sd_2_1(pair):
    _jsd, tsd = pair
    tp = TPipe(tsd)
    for sd_2_1 in (False, True):
        spec = tp._prepare(PrepareOptions(meta_prompt=META, sd_2_1=sd_2_1))[3]
        prompt, anns, custom = tann.parse_prompt(META)
        want = tbuild(tsd.tokenizer, prompt, anns, THP(), custom, attention_res=16, normalize_eot=sd_2_1, device="cpu")
        np.testing.assert_array_equal(spec.valid_text.numpy(), want.valid_text.numpy())


@pytest.fixture(scope="module")
def traces(pair, tmp_path_factory):
    """The JAX tool's sd_2_1 trace of micro_sd21 and the port's, from JAX's
    initial latent, with JAX's re-noise draws handed to the port."""
    jsd, tsd = pair
    d = tmp_path_factory.mktemp("sd21trace")
    lat0, noise = jax_draws(JPipe(jsd), SEED)
    init = str(d / "init.npy")
    np.save(init, lat0)
    files = {"jax": str(d / "jax.npz"), "torch": str(d / "torch.npz")}
    argv = ["trace", "--model", "micro", "--steps", str(STEPS), "--seed", str(SEED), "--thresholds", "0:0.0",
            "--sd_2_1", "--latents", init, "--cpu", "--out", files["jax"]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbundle.StableDiffusion, "create", lambda *a, **k: jsd)
        assert jpt.main(argv) == 0
    tpt.save(files["torch"], tpt.trace(TPipe(tsd), latents=lat0, noise=noise, **TRACE_KW))
    return files, lat0, noise


def test_guided_sd21_trace_matches_jax(traces, capsys):
    files, _lat0, _noise = traces
    rows = {}
    assert tpt.compare(files["jax"], files["torch"], rows=rows)
    assert jpt.main(["compare", files["jax"], files["torch"]]) == 0
    t = np.load(files["torch"])
    # step 0: eval0, ten refinements and the final eval in each of three recursions
    assert t["eval_mask"][0].all() and not t["eval_mask"][1:].any()
    assert rows["eval_unscaled"]["n"] == 12 * 77 and rows["final_latents"]["max_abs"] < 1e-4
    assert capsys.readouterr().out.count("PARITY: PASS") == 2


def test_sd_2_1_reaches_the_loss(pair, traces):
    """Without sd_2_1 the same run normalizes over all 75 slots: its losses
    differ from the normalized run's."""
    _jsd, tsd = pair
    files, lat0, noise = traces
    plain = tpt.trace(TPipe(tsd), latents=lat0, noise=noise, **dict(TRACE_KW, sd_2_1=False))
    normalized = np.load(files["torch"])
    assert np.abs(plain["total_loss"][0] - normalized["total_loss"][0]) > 1e-3


def test_workload_follows_the_bundle_preset():
    """``workload.generate`` and ``generate_batch`` pass sd_2_1 for an sd21
    bundle, and only then."""
    calls = []

    class Pipe:
        def __init__(self, name):
            self.sd = type("SD", (), {"config": type("C", (), {"name": name})()})()

        def __call__(self, **kw):
            calls.append(kw)

        def generate_batch(self, seeds, **kw):
            calls.append(kw)

    for name, want in (("sd21", True), ("sd15", False), ("micro", False)):
        workload.generate(Pipe(name), 1)
        workload.generate_batch(Pipe(name), [1, 2], steps=2)
        assert [c["sd_2_1"] for c in calls[-2:]] == [want, want], name
    workload.generate_batch(Pipe("sd21"), [1], sd_2_1=False)
    assert calls[-1]["sd_2_1"] is False


def test_cli_sd_2_1_picks_sd21_and_writes_its_tree(tmp_path, monkeypatch):
    """``--sd_2_1 true`` builds the sd21 preset (no --model) and its runs
    normalize the EOT; at micro it writes the artifact tree."""
    from guided_attention_tpu_torch import runner

    made = []
    real_create = TSD.create

    def create(model, dtype, device="cuda", **kw):
        made.append(model)
        return real_create("micro", dtype, device=device, **kw)

    monkeypatch.setattr(runner.StableDiffusion, "create", staticmethod(create))
    dispatched = []
    real_dispatch = TPipe.dispatch

    def dispatch(self, *a, **kw):
        dispatched.append(kw["sd_2_1"])
        return real_dispatch(self, *a, **kw)

    monkeypatch.setattr(TPipe, "dispatch", dispatch)
    out = tmp_path / "out"
    tcli.main(["--meta_prompt", META, "--sd_2_1", "true", "--device", "cpu", "--dtype", "float32",
               "--n_inference_steps", "2", "--seeds", "3", "--output_path", str(out)])
    assert made == ["sd21"] and dispatched == [True]
    run_dir = out / tann.meta_prompt_clean(META)
    pngs = [p for p in os.listdir(run_dir) if p.startswith("3") and p.endswith(".png")]
    assert len(pngs) == 1 and os.path.isdir(run_dir / "3")
    assert (out / (tann.meta_prompt_clean(META) + ".png")).exists()
