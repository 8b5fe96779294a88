"""The port's CLI path (``frontends/cli.py``, ``RunConfig``, the runner's
``trim_heavy_diags``) against the JAX package's, and the guided path's
determinism repair, on the CPU.

* ``parse_args``, ``state_prompts``, ``plan_batch_chunks`` and
  ``get_hyperparam_states`` equal the JAX package's on the same argv lists,
  and ``execute`` hands ``dispatch`` / ``dispatch_batch`` the same keywords
  (the --thresholds precedence included).
* ``_trim_plan`` equals JAX's on the same statics; a trimmed run scattered
  back equals the untrimmed run.
* ``cli.main`` on the micro model writes the tree that the JAX package's
  ``execute`` writes when it is handed the same generations: the same
  relative paths, run logs and decoded pixels (no JAX program is built:
  JAX's execute drives a stand-in pipeline that returns the port's
  outputs and decodes with the port's VAE).
* Every option the port does not run yet (the mesh's tensor axis) raises
  NotImplementedError, and
  ``--interactive`` hands over to the web UI (``gui.run_server``).
* The smoothing's reflect padding, rebuilt from slices (the CUDA backward of
  ``F.pad(mode="reflect")`` accumulates with atomics), equals ``F.pad``'s
  and its gradient.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from guided_attention_tpu import config as jconfig
from guided_attention_tpu import runner as jrunner
from guided_attention_tpu.frontends import cli as jcli
from guided_attention_tpu.pipeline import GenStatics as JStatics

from guided_attention_tpu_torch import config as tconfig
from guided_attention_tpu_torch.annotation import meta_prompt_clean
from guided_attention_tpu_torch import runner as trunner
from guided_attention_tpu_torch.frontends import cli as tcli
from guided_attention_tpu_torch.guidance import smoothing
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.pipeline import GenStatics as TStatics
from guided_attention_tpu_torch.runtime.artifacts import decode_numpy

from test_torch_port_artifacts import read_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


META = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
META2 = "a [robot:0,.1,.45,.5] and a [vase:.55,.4,.4,.5]"
ARGVS = [
    [],
    ["--meta_prompt", META, "--seeds", "3", "4", "--thresholds", '{"0": 0.5, "3": 0.2}', "--run_standard_sd", "true"],
    ["--meta_prompts", META, META2, "--seeds", "1", "2", "3", "--batch_size", "2", "--scale_range", "1.0", "0.2",
     "--half_precision", "true", "--hyperparam_iterations", '[{"strict": true}, {"meta_prompt": "a [x:.1,.2] y"}]'],
    ["--meta_prompt", META, "--diagnostic_level", "2", "--save_individual_ca_maps", "true", "--eta", "0.3",
     "--output_path", "out/x", "--model", "micro", "--dtype", "float32", "--kernel_size", "5"],
]


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("device", None)  # the port's own field
    return d


def _hp(hp) -> dict:
    return dataclasses.asdict(hp)


@pytest.mark.parametrize("argv", ARGVS)
def test_parsing_and_sweep_plan_equal_the_jax_package(argv):
    jc, tc = jcli.parse_args(argv), tcli.parse_args(argv)
    assert _fields(tc) == _fields(jc)
    assert set(_fields(tc)) == {f.name for f in dataclasses.fields(jconfig.RunConfig)}
    assert tc.device == "cuda"
    assert tc._thresholds_explicit == jc._thresholds_explicit == ("--thresholds" in argv)
    jstates = jconfig.get_hyperparam_states(jconfig.HyperParams(), jc.hyperparam_iterations)
    tstates = tconfig.get_hyperparam_states(tconfig.HyperParams(), tc.hyperparam_iterations)
    assert [_hp(h) for h in tstates] == [_hp(h) for h in jstates]
    for jh, th in zip(jstates, tstates):
        assert tcli.state_prompts(tc, th) == jcli.state_prompts(jc, jh)
    jplan = [(_hp(h), chunk) for h, chunk in jcli.plan_batch_chunks(jc, jstates)]
    tplan = [(_hp(h), chunk) for h, chunk in tcli.plan_batch_chunks(tc, tstates)]
    assert tplan == jplan
    assert tconfig.DEFAULT_HYPERPARAM_ITERATIONS == jconfig.DEFAULT_HYPERPARAM_ITERATIONS


class _Stop(Exception):
    pass


class _RecordingPipe:
    """Records each dispatch's keywords; its results stop the sweep."""

    def __init__(self):
        self.calls = []

    def _record(self, kind, args, kw):
        kw = dict(kw)
        kw.pop("mesh", None)  # the JAX package's device mesh
        kw["hp"] = _hp(kw["hp"])
        self.calls.append((kind, list(args), kw))
        return types.SimpleNamespace(result=self._stop)

    def _stop(self):
        raise _Stop

    def dispatch(self, *args, **kw):
        return self._record("dispatch", args, kw)

    def dispatch_batch(self, *args, **kw):
        return self._record("dispatch_batch", args, kw)


@pytest.mark.parametrize("argv", ARGVS[1:] + [["--meta_prompt", META, "--seeds", "5", "6"]])
def test_execute_dispatches_as_the_jax_package(argv, tmp_path):
    """The first dispatch of a sweep: the sweep state's hyperparameters (the
    base state's thresholds {0: 1.0} unless --thresholds is given), every
    run keyword, and trim_heavy_diags."""
    argv = argv + ["--output_path", str(tmp_path)]
    jp, tp = _RecordingPipe(), _RecordingPipe()
    for cli, pipe in ((jcli, jp), (tcli, tp)):
        with pytest.raises(_Stop):
            cli.execute(cli.parse_args(argv), pipe)
    assert tp.calls[0] == jp.calls[0]
    explicit = "--thresholds" in argv
    assert tp.calls[0][2]["hp"]["thresholds"] == ({0: 0.5, 3: 0.2} if explicit else {0: 1.0})


# ---- trim_heavy_diags ----
@pytest.mark.parametrize("kw, hp", [
    (dict(num_steps=10), dict()),
    (dict(num_steps=10), dict(thresholds={0: 1.0, 3: 0.5, 12: 0.2})),
    (dict(num_steps=8, only_update_on_threshold_steps=False, max_iter_to_alter=4), dict(thresholds={6: 0.3})),
    (dict(num_steps=6, run_standard_sd=True), dict()),
    (dict(num_steps=6, skip_inert_guidance_passes=False), dict()),
])
def test_trim_plan_equals_the_jax_package(kw, hp):
    want = jrunner._trim_plan(JStatics(**kw), jconfig.HyperParams(**hp))
    got = trunner._trim_plan(TStatics(**kw), tconfig.HyperParams(**hp))
    assert got == want


@pytest.fixture(scope="module")
def micro_pipe():
    return trunner.GuidedAttentionPipeline(TSD.create("micro", torch.float32, device="cpu"))


@pytest.mark.parametrize("batch", [False, True])
def test_trimmed_run_scatters_back_to_the_untrimmed(micro_pipe, batch):
    # thresholds met at the first eval: one eval at each of steps 0 and 2
    kw = dict(num_inference_steps=5, thresholds={0: 50.0, 2: 50.0}, decode=False)
    if batch:
        full = micro_pipe.generate_batch([1, 2], meta_prompts=[META, META2], **kw)
        trim = micro_pipe.dispatch_batch([1, 2], meta_prompts=[META, META2], trim_heavy_diags=True, **kw).result()
    else:
        full = [micro_pipe(meta_prompt=META, seed=1, **kw)]
        trim = [micro_pipe.dispatch(meta_prompt=META, seed=1, trim_heavy_diags=True, **kw).result()]
    for f, t in zip(full, trim):
        fd, td = f.diagnostics, t.diagnostics
        assert fd.eval_mask[[0, 2]].any() and not fd.eval_mask[[1, 3, 4]].any()
        for name in ("x0_pred", "latent_in"):
            assert getattr(td, name).shape[0] == 3
            np.testing.assert_array_equal(getattr(td, name), getattr(fd, name)[:3], err_msg=name)
        for field in dataclasses.fields(fd):
            if field.name not in ("x0_pred", "latent_in"):
                np.testing.assert_array_equal(getattr(td, field.name), getattr(fd, field.name), err_msg=field.name)
        np.testing.assert_array_equal(t.latents, f.latents)


# ---- the CLI end to end ----
class _JaxStandIn:
    """Hands the JAX package's ``execute`` the port's generations, by
    (seed, meta_prompt), and decodes its x0 previews with the port's VAE."""

    def __init__(self, port_pipe, outs):
        self.outs = outs
        self.sd = types.SimpleNamespace(decode_latents=lambda lat: decode_numpy(port_pipe, lat),
                                        tokenizer=port_pipe.sd.tokenizer)

    def dispatch(self, meta_prompt, seed, **kw):
        return types.SimpleNamespace(result=lambda: self.outs[(seed, meta_prompt)])

    def dispatch_batch(self, seeds, meta_prompt=None, meta_prompts=None, **kw):
        prompts = meta_prompts or [meta_prompt] * len(seeds)
        return types.SimpleNamespace(result=lambda: [self.outs[(s, mp)] for s, mp in zip(seeds, prompts)])


@pytest.mark.parametrize("batch_size", ["1", "2"])
def test_cli_main_writes_the_tree_jax_execute_writes(tmp_path, monkeypatch, batch_size):
    argv = ["--meta_prompt", META, "--model", "micro", "--n_inference_steps", "3", "--seeds", "1", "2",
            "--batch_size", batch_size, "--dtype", "float32"]
    rec = {"outs": {}}
    real_setup, real_write = tcli.setup, tcli.write_run_artifacts

    def setup(config):
        rec["pipe"] = real_setup(config)
        return rec["pipe"]

    def write(pipe, out, **kw):
        rec["outs"][(kw["seed"], kw["meta_prompt"])] = out
        return real_write(pipe, out, **kw)

    monkeypatch.setattr(tcli, "setup", setup)
    monkeypatch.setattr(tcli, "write_run_artifacts", write)
    tcli.main(argv + ["--device", "cpu", "--output_path", str(tmp_path / "port")])
    assert rec["pipe"].sd.device.type == "cpu" and rec["pipe"].sd.config.unet.dtype == torch.float32
    jcli.execute(jcli.parse_args(argv + ["--output_path", str(tmp_path / "jax")]), _JaxStandIn(rec["pipe"], rec["outs"]))

    jt = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*") if p.is_file())
    tt = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert tt == jt
    # per seed: final image, run log, 3 x0 previews, and step-0 maps for the two words; then the grid
    assert len(tt) == 2 * (2 + 3 + 2) + 1
    for rel in tt:
        j, t = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".txt"):
            assert t.read_text() == j.read_text(), rel
        else:
            np.testing.assert_array_equal(read_png(t), np.asarray(Image.open(j).convert("RGB")), err_msg=rel)
    grid = read_png(tmp_path / "port" / (meta_prompt_clean(META) + ".png"))
    assert grid.shape == (128, 256, 3)  # two 128x128 images side by side


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    argv = ["--meta_prompt", META, "--model", "micro", "--device", "cpu", "--dtype", "float32", "--run_standard_sd",
            "true", "--n_inference_steps", "1", "--seeds", "1", "--output_path", str(tmp_path / "out"),
            "--profile_dir", str(tmp_path / "trace")]
    tcli.main(argv)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


@pytest.mark.parametrize("flag", [
    ["--mesh_shape", '{"data": 1, "tensor": 2}'],
    ["--mesh_shape", '{"tensor": 2}', "--interactive", "true"],
    ["--checkpoint_every", "5", "--mesh_shape", '{"tensor": 2}'],
])
def test_unsupported_options_raise(flag, tmp_path):
    """The tensor axis runs (the two-rank launch of
    ``tests/test_torch_port_parallel.py``); a mesh larger than the process
    group is refused, by the sweep and the web UI alike, before any
    generation."""
    argv = ["--meta_prompt", META, "--model", "micro", "--device", "cpu", "--output_path", str(tmp_path)] + flag
    with pytest.raises(ValueError, match="needs 2 processes; the process group has 1"):
        tcli.main(argv)
    with pytest.raises(ValueError, match="needs 2 processes; the process group has 1"):
        tcli.execute(tcli.parse_args(argv), pipe=None)


def test_interactive_serves_the_web_ui(tmp_path, monkeypatch):
    """``--interactive true`` hands the config and the pipeline to
    ``gui.run_server``, as the JAX CLI does, and runs no sweep."""
    from guided_attention_tpu_torch.frontends import gui

    served = []
    monkeypatch.setattr(gui, "run_server", lambda config, pipe: served.append((config, pipe)))
    monkeypatch.setattr(tcli, "execute", lambda *a, **k: pytest.fail("--interactive ran the sweep"))
    argv = ["--meta_prompt", "", "--model", "micro", "--device", "cpu", "--dtype", "float32", "--output_path",
            str(tmp_path), "--interactive", "true"]
    tcli.main(argv)
    (config, pipe), = served
    assert config.interactive and config.output_path == tmp_path
    assert isinstance(pipe, trunner.GuidedAttentionPipeline) and pipe.sd.config.name == "micro"
    assert pipe.sd.device.type == "cpu"


# ---- the guided path's determinism (the reflect padding's backward) ----
def _mirror_with_edge(x, pad):
    """A wrong padding: mirrors including the edge row (symmetric)."""
    for dim in (-2, -1):
        n = x.shape[dim]
        x = torch.cat([x.narrow(dim, 0, pad).flip(dim), x, x.narrow(dim, n - pad, pad).flip(dim)], dim=dim)
    return x


def _pad_mismatch(pad_fn, x, pad, seed):
    """(forward max error, gradient max error) of ``pad_fn`` against
    ``F.pad(mode="reflect")`` on ``x``, gradients through random weights."""
    w = torch.randn(x.shape[:-2] + (x.shape[-2] + 2 * pad, x.shape[-1] + 2 * pad),
                    generator=torch.Generator().manual_seed(seed), dtype=torch.float64).float()
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    a, b = pad_fn(xa, pad), F.pad(xb, (pad,) * 4, mode="reflect")
    (ga,) = torch.autograd.grad((a * w).sum(), xa)
    (gb,) = torch.autograd.grad((b * w).sum(), xb)
    return float((a - b).detach().abs().max()), float((ga - gb).abs().max())


@pytest.mark.parametrize("pad", [1, 2])
def test_reflect_pad_equals_f_pad_and_its_gradient(pad):
    rng = np.random.default_rng(pad)
    x = torch.from_numpy(rng.random((6, 1, 16, 16)).astype(np.float32))
    fwd, grad = _pad_mismatch(smoothing.reflect_pad, x, pad, pad)
    assert fwd == 0.0  # the same values, copied
    assert grad <= 1e-6  # the same sums, maybe in another order
    # a padding that repeats the edge is told apart
    fwd_bad, grad_bad = _pad_mismatch(_mirror_with_edge, x, pad, pad)
    assert fwd_bad > 1e-2 and grad_bad > 1e-2
    maps = torch.from_numpy(rng.random((16, 16, 77)).astype(np.float32)).movedim(-1, 0)
    k = 2 * pad + 1
    want = F.conv2d(F.pad(maps[:, None], (pad,) * 4, mode="reflect"),
                    torch.from_numpy(smoothing.gaussian_kernel(k, 0.5))[None, None])[:, 0]
    torch.testing.assert_close(smoothing.smooth_maps(maps, k, 0.5), want, rtol=0, atol=1e-6)
