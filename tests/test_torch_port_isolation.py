"""The PyTorch port stands alone: no jax, no flax, no msgpack or ml_dtypes
(the card's machine has neither), nothing of the JAX package, and no silent
CPU fallback for its CUDA default."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import guided_attention_tpu_torch
from guided_attention_tpu_torch.models.bundle import StableDiffusion


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny tensors; one intra-op thread keeps them from
    competing for cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(guided_attention_tpu_torch.__file__)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack|ml_dtypes|guided_attention_tpu)(\.|\s|$)", re.M)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with jax/flax, msgpack and ml_dtypes
    (and PIL, matplotlib, cv2 and sklearn, which only options and the
    viewers import, inside their calls) made unimportable,
    no module of the JAX package gets loaded along the way, and the native
    artifact writer loaded is the port's own."""
    code = (
        "import sys, pkgutil, importlib, tempfile, os\n"
        "for name in ('jax', 'flax', 'msgpack', 'ml_dtypes', 'PIL', 'matplotlib', 'cv2', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import guided_attention_tpu_torch as p, chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, 'guided_attention_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'guided_attention_tpu' or m.startswith('guided_attention_tpu.')]\n"
        "assert not bad, bad\n"
        # the port's own native writer, not the JAX package's library
        "from guided_attention_tpu_torch.runtime.native import AsyncArtifactWriter\n"
        "w = AsyncArtifactWriter(1); assert w.native\n"
        "w.submit_map(__import__('numpy').eye(4, dtype='float32'), os.path.join(tempfile.mkdtemp(), 'm.png')); w.close()\n"
        "libs = open('/proc/self/maps').read()\n"
        "assert 'libartifact_writer' in libs and 'guided_attention_tpu/runtime/native' not in libs\n"
        "print('n_modules', sum(1 for m in sys.modules if m.startswith('guided_attention_tpu_torch')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    n = int(res.stdout.split("n_modules")[1])
    assert n >= 20  # every module was really imported


def test_port_sources_import_no_jax():
    hits = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append((os.path.relpath(path, REPO), m.group(0).strip()))
    assert not hits, hits
    assert len(_port_sources()) >= 20


def test_port_package_has_every_counterpart_module():
    prefix = "guided_attention_tpu_torch."
    names = {m.name[len(prefix):] for m in pkgutil.walk_packages(guided_attention_tpu_torch.__path__, prefix)}
    for want in (
        "config", "annotation", "pipeline", "runner", "models.unet", "models.clip", "models.vae",
        "models.configs", "models.bundle", "models.convert", "models.tokenizer", "ops.attention",
        "ops.flash_attention", "schedulers.ddim", "guidance.spec", "guidance.smoothing",
        "guidance.losses", "guidance.custom", "ops.attention_variants", "runtime.flops",
        "runtime.timing", "perf_attn_kernel", "workload", "profile", "perf_batch",
        "runtime.artifacts", "runtime.native", "viewers.vis", "frontends.cli", "runtime.serialization",
        "runtime.checkpoint", "models.io", "frontends.server", "frontends.gui", "perf_server", "parity_trace",
        "parallel.batch", "parallel.mesh", "parallel.multihost", "viewers.batch_map_view",
        "viewers.self_attn_clusters", "perf_unet", "perf_host_tail",
    ):
        assert want in names, want
    for src in ("flash_self_fwd.cu", "flash_self_bwd.cu", "cross_attention_map.cu", "flash_self_fwd_v1.cu",
                "flash_self_bwd_w1.cu", "common.cuh"):
        assert os.path.exists(os.path.join(PKG_DIR, "csrc", src)), src
    # the port's own native writer: its source, and no prebuilt library in the package
    native = os.path.join(PKG_DIR, "runtime", "native")
    assert os.path.exists(os.path.join(native, "artifact_writer.cpp"))
    assert not [n for n in os.listdir(native) if n.endswith(".so")]
    # the web UI's own copy of the page, read from the port's directory
    assert os.path.exists(os.path.join(PKG_DIR, "frontends", "web", "ui.html"))


# each of the JAX package's scripts and its counterpart in the port: a module
# of the package, or a root file
SCRIPT_COUNTERPARTS = {
    "check_kernels_tpu.py": "chip_smoke.py",  # phase 3 holds every kernel against its plain version on the card
    "parity_trace.py": "parity_trace",
    "perf_attn_kernel.py": "perf_attn_kernel",
    "perf_batch.py": "perf_batch",
    "perf_host_tail.py": "perf_host_tail",
    "perf_server.py": "perf_server",
    "perf_unet.py": "perf_unet",
    "profile_guided.py": "profile",  # its HLO join: the op and module breakdown
}
# what has no counterpart, by script or "script --option", and why
NO_COUNTERPART = {
    "perf_batch.py --pipelined": "it overlaps one call's pull with the next call's device work, which a JAX "
    "array allows because it is a future; the port's loop reads host values at every guidance eval, so its "
    "dispatch returns when its work is done and there is nothing to overlap",
    "reference_trace.py": "it runs inside the original PyTorch reference's own environment (diffusers 0.12.1) "
    "and hooks that code; it belongs to neither package",
}


def test_every_jax_script_has_a_counterpart_or_a_reason():
    scripts = sorted(n for n in os.listdir(os.path.join(REPO, "scripts")) if n.endswith(".py"))
    prefix = "guided_attention_tpu_torch."
    modules = {m.name[len(prefix):] for m in pkgutil.walk_packages(guided_attention_tpu_torch.__path__, prefix)}
    whole = {k for k in NO_COUNTERPART if " " not in k}
    for script in scripts:
        assert (script in SCRIPT_COUNTERPARTS) != (script in whole), script
    for script, port in SCRIPT_COUNTERPARTS.items():
        assert script in scripts, script
        assert port in modules or os.path.exists(os.path.join(REPO, port)), port
    for item, reason in NO_COUNTERPART.items():
        script, _, option = item.partition(" ")
        assert script in scripts and len(reason) > 40, item
        if option:
            with open(os.path.join(REPO, "scripts", script)) as f:
                assert option in f.read(), item
    # the options kept out are said to be so where the counterpart lives
    with open(os.path.join(PKG_DIR, "perf_batch.py")) as f:
        assert "--pipelined" in f.read()


def test_default_device_is_cuda_and_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device, so the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        StableDiffusion.create("micro")
    with pytest.raises(RuntimeError, match="cuda"):
        StableDiffusion.create("micro", torch.float32, device="cuda:0")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    from guided_attention_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 64, 16, generator=g) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_self_plain(q.reshape(2, 64, 16), k.reshape(2, 64, 16), v.reshape(2, 64, 16), 0.25)
    torch.testing.assert_close(out.reshape(2, 64, 16), ref, rtol=0, atol=0)
    kc, vc = torch.randn(1, 2, 77, 16, generator=g), torch.randn(1, 2, 77, 16, generator=g)
    o, m = fa.cross_attention_with_map(q, kc, vc)
    o2, m2 = fa.cross_attention_map_plain(q, kc, vc, 0.25)
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(m, m2, rtol=0, atol=0)
    assert all(v == 0 for v in fa.LAUNCHES.values())


def test_kernel_launchers_refuse_cpu_tensors():
    """The launch functions never compute on the CPU: they raise."""
    from guided_attention_tpu_torch.ops import flash_attention as fa

    x = torch.zeros(2, 64, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_self_fwd(x, x, x, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fa.cross_attention_map_fwd(x[None], x[None], x[None], 0.25)
