"""Native msgpack checkpoints in the port (``runtime/serialization``,
``models/io``, ``models/convert.params_to_jax`` and the converter CLI)
against flax's format and the JAX package's ``models/io`` on the CPU.

* The port's codec reads what ``flax.serialization.msgpack_serialize``
  writes (every dtype the checkpoints and state files hold, numpy scalars,
  nested maps, flax's chunked form of large arrays) and writes the same
  bytes, which ``msgpack_restore`` reads back.
* A directory written by either package's ``save_params`` loads in the
  other, bitwise equal (micro, float32; the JAX side's parameters drawn by
  numpy, no jitted init). At sd21 the port's flax names and layouts of
  the UNet (``params_to_jax``) are held against the JAX package's tree by
  path and shape: the port's UNet is built on the meta device and JAX's
  tree by ``jax.eval_shape``, so nothing is allocated or compiled.
* The converter CLI turns a diffusers directory into a native one that
  ``StableDiffusion.create`` loads equal to the diffusers load.
* bfloat16 decodes with ``ml_dtypes`` and ``msgpack`` unimportable, as on a
  machine that has neither.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs

from guided_attention_tpu.models import io as jio

from guided_attention_tpu_torch.models import bundle, io as tio
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.models import configs as tconfigs
from guided_attention_tpu_torch.models.convert import _jax_leaves, main as convert_main
from guided_attention_tpu_torch.models.tokenizer import SimpleTokenizer
from guided_attention_tpu_torch.models.unet import UNet2DCondition
from guided_attention_tpu_torch.runtime import serialization as ps

from test_torch_port_checkpoint import ckpt  # noqa: F401  (the synthesized micro diffusers directory)
from torch_port_helpers import jax_micro_bundle, jax_param_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPONENTS = ("unet", "text_encoder", "vae")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    rng = np.random.default_rng(0)
    return {
        "unet": {
            "conv_in": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                        "bias": np.asarray(jnp.asarray(rng.standard_normal(8), jnp.bfloat16))},
            "norm": {"scale": rng.standard_normal(300).astype(np.float16)},
        },
        "ids": np.arange(-5, 70000, 997, dtype=np.int32),
        "mask": rng.standard_normal((2, 3)) > 0,
        "empty": np.zeros((0, 4), np.float32),
        "scalars": {"f32": np.float32(0.25), "i32": np.int32(-7), "bool": np.bool_(True)},
        "step": 12, "neg": -300, "big": 2**40, "name": "genstate", "long": "x" * 300, "flag": False, "none": None,
        "ratio": 0.5, "list": [1, "a", 2.0],
    }


def _bits(x):
    """Comparable bits of a leaf: bfloat16 through its uint16 view."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert list(got) == list(want), path
    elif hasattr(want, "shape") and hasattr(want, "dtype"):  # numpy, jax or torch arrays and numpy scalars
        g, w = _bits(got), _bits(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_codec_reads_flax_bytes_and_writes_them(tmp_path):
    tree = _tree()
    data = fs.msgpack_serialize(tree)
    got = ps.loads(data)
    _assert_same_tree(got, tree)
    bias = got["unet"]["conv_in"]["bias"]
    assert isinstance(bias, torch.Tensor) and bias.dtype == torch.bfloat16
    assert isinstance(got["scalars"]["f32"], np.float32) and isinstance(got["ids"], np.ndarray)
    # written back (bfloat16 as torch tensors) to flax's very bytes
    assert ps.dumps(got) == data
    _assert_same_tree(fs.msgpack_restore(ps.dumps(got)), tree)
    # file round trip through one read
    n = ps.dump(got, tmp_path / "t.msgpack")
    assert n == len(data) == (tmp_path / "t.msgpack").stat().st_size
    _assert_same_tree(ps.load(tmp_path / "t.msgpack"), tree)
    # torn data raises (state files skip it); other ext types are refused
    with pytest.raises(ValueError):
        ps.loads(data[:-3])
    with pytest.raises(ValueError):
        ps.loads(fs.msgpack_serialize({"c": 1 + 2j}))


def test_codec_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ps, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"emb": rng.standard_normal((7, 9)).astype(np.float32),
            "bf": np.asarray(jnp.asarray(rng.standard_normal((5, 21)), jnp.bfloat16)),
            "small": np.arange(4, dtype=np.int32)}
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = ps.loads(data)
    _assert_same_tree(got, tree)
    assert ps.dumps(got) == data
    _assert_same_tree(fs.msgpack_restore(ps.dumps(got)), tree)


@pytest.fixture(scope="module")
def jax_and_port():
    jsd = jax_micro_bundle()
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jsd.params)
    return jsd, tsd


def _assert_same_modules(a, b):
    for name in COMPONENTS:
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), (name, k)


def test_jax_save_params_loads_in_the_port(jax_and_port, tmp_path):
    jsd, tsd = jax_and_port
    jio.save_params(str(tmp_path), jsd.params)
    assert tio.is_native_checkpoint(str(tmp_path)) and not tio.is_native_checkpoint(str(tmp_path / "no"))
    _assert_same_modules(TSD.create("micro", torch.float32, device="cpu", checkpoint_dir=str(tmp_path)), tsd)


def test_port_save_params_loads_in_jax(jax_and_port, tmp_path):
    jsd, tsd = jax_and_port
    n = tio.save_params(str(tmp_path), tsd)
    assert n == sum(len(getattr(tsd, c).state_dict()) for c in COMPONENTS)
    assert sorted(os.listdir(tmp_path)) == [f"{c}.msgpack" for c in sorted(COMPONENTS)]
    back = jio.load_params(str(tmp_path), jsd.params)
    _assert_same_tree(back, {c: jsd.params[c] for c in COMPONENTS})
    # and in the port again
    _assert_same_modules(TSD.create("micro", torch.float32, device="cpu", checkpoint_dir=str(tmp_path)), tsd)


def test_params_to_jax_names_match_the_jax_sd21_unet():
    """Every port UNet parameter at sd21 lands on the JAX tree's path with
    its shape, and every JAX leaf is filled: the JAX package's
    ``load_params`` takes the exact tree. sd21's UNet has what micro's
    lacks: two layers per block, attention in three blocks, and Linear
    ``proj_in`` / ``proj_out``; sd15's differs from it only by micro's
    convolution projections. The text encoder's and the VAE's names depend
    on the preset only through layer indices."""
    cfg = tconfigs.get_config("sd21", torch.bfloat16)
    with torch.device("meta"):
        unet = UNet2DCondition(cfg.unet)
    shapes = jax_param_shapes("sd21", jnp.bfloat16, ("unet",))["unet"]
    want = {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: tuple(t.shape) for path, t in _jax_leaves(unet, "unet")}
    assert len(got) == len(unet.state_dict())
    assert sorted(set(got) ^ set(want))[:8] == []
    assert got == want
    assert want[("down_blocks_0_attentions_1", "proj_in", "kernel")] == (320, 320)  # Linear, [in, out]


def test_converter_cli(ckpt, tmp_path, capsys, monkeypatch):  # noqa: F811
    root, _sds = ckpt
    hf = tmp_path / "hf"
    shutil.copytree(root, hf)
    (hf / "tokenizer").mkdir()
    (hf / "tokenizer" / "vocab.json").write_text(json.dumps({"a": 0}))
    # the stand-in tokenizer folder is not a loadable CLIP tokenizer: record
    # which directory the bundle would load it from instead
    tokenizer_dirs = []
    monkeypatch.setattr(bundle, "load_tokenizer", lambda d: tokenizer_dirs.append(d) or SimpleTokenizer())
    out = tmp_path / "native"
    convert_main([str(hf), str(out), "--model", "micro", "--dtype", "float32", "--device", "cpu"])
    assert "converted 656 tensors" in capsys.readouterr().out
    assert (out / "tokenizer" / "vocab.json").read_text() == (hf / "tokenizer" / "vocab.json").read_text()
    assert sorted(os.listdir(out)) == ["text_encoder.msgpack", "tokenizer", "unet.msgpack", "vae.msgpack"]
    native = TSD.create("micro", torch.float32, device="cpu", checkpoint_dir=str(out))
    assert tokenizer_dirs == [str(hf), str(out)]
    _assert_same_modules(native, TSD.create("micro", torch.float32, device="cpu", checkpoint_dir=root))


def test_bf16_decodes_without_ml_dtypes_or_msgpack(tmp_path):
    rng = np.random.default_rng(2)
    w = np.asarray(jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16))
    (tmp_path / "in.msgpack").write_bytes(fs.msgpack_serialize({"w": w, "b": np.float32(2.0) * np.ones(3, np.float32)}))
    np.save(tmp_path / "bits.npy", w.view(np.uint16))
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from guided_attention_tpu_torch.runtime import serialization as ps\n"
        f"d = {str(tmp_path)!r}\n"
        "t = ps.load(d + '/in.msgpack')\n"
        "assert t['w'].dtype == torch.bfloat16 and tuple(t['w'].shape) == (3, 5)\n"
        "assert (t['w'].view(torch.int16).numpy().view(np.uint16) == np.load(d + '/bits.npy')).all()\n"
        "assert (t['b'] == 2.0).all()\n"
        "ps.dump({'w': t['w'] * 2, 'b': t['b']}, d + '/out.msgpack')\n"
        "print('decoded')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "decoded" in res.stdout, res.stderr[-2000:]
    back = fs.msgpack_restore((tmp_path / "out.msgpack").read_bytes())
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["w"].astype(np.float32), (w.astype(np.float32) * 2))
