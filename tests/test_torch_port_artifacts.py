"""The port's artifact tree (``runtime/artifacts.py``, the native PNG writer)
against the JAX package's.

Fed the same synthetic ``PipelineOutput`` (numpy ``StepDiag`` fields drawn
from a seed, four steps, two sub-prompts) and the same stub decoder, both
packages' ``write_run_artifacts`` must write the same relative paths, the
same run-log text and PNGs whose decoded pixels are equal. The grid and
``annotate`` (boxes and crosshairs, which the port draws in numpy, and the
labels, which both draw with Pillow) must be pixel-equal too.

The per-head map dump and the diagnostic x0 snapshots re-run the models, so
they run through the micro models with the JAX package's weights
(``params_from_jax``) in float32: the per-head maps within 1e-4 of their
largest value, the decoded PNGs within one level of 255 in at most 0.1% of
their pixels. No JAX guided program is built here.
"""
import functools
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import jax
import torch
from PIL import Image

from guided_attention_tpu.annotation import parse_prompt as jax_parse_prompt
from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.runner import GuidedAttentionPipeline as JPipe
from guided_attention_tpu.runtime import artifacts as ja
from guided_attention_tpu.runtime import native as jnative

from guided_attention_tpu_torch.annotation import parse_prompt
from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.models.bundle import StableDiffusion as TSD
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline as TPipe
from guided_attention_tpu_torch.runtime import artifacts as ta
from guided_attention_tpu_torch.runtime import native as tnative

from torch_port_helpers import jax_micro_bundle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


META = "a [robot:.6,.3,.4,.55] and a [blue vase:.2,.7] x"
WORDS = [(2, "robot"), (5, "blue vase")]
S, R, K, R_SUB, LAT = 4, 8, 77, 12, 8


def read_png(path) -> np.ndarray:
    """Decode an 8-bit RGB PNG with the standard library's zlib, checking
    every chunk's CRC."""
    b = Path(path).read_bytes()
    assert b[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(b):
        (n,) = struct.unpack(">I", b[pos : pos + 4])
        kind, data = b[pos + 4 : pos + 8], b[pos + 8 : pos + 8 + n]
        assert zlib.crc32(kind + data) == struct.unpack(">I", b[pos + 8 + n : pos + 12 + n])[0]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
            assert (depth, color) == (8, 2)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    assert not rows[:, 0].any()  # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def read_any(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def stub_decode(lat):
    """Latents [n, h, w, 4] -> images [n, 8h, 8w, 3] in [0, 1]."""
    x = np.asarray(lat, np.float32)[..., :3]
    return 1.0 / (1.0 + np.exp(-np.repeat(np.repeat(x, 8, axis=1), 8, axis=2)))


def synthetic_output(annotations, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((S, R_SUB), bool)
    mask[0, :4] = True
    mask[2, [0, R_SUB - 1]] = True
    d = types.SimpleNamespace(
        total_loss=rng.random(S).astype(np.float32),
        eval_mask=mask,
        eval_unscaled=rng.random((S, R_SUB, K)).astype(np.float32),
        token_attn_sum=rng.random((S, K)).astype(np.float32),
        col=rng.random((S, K)).astype(np.float32) * R,
        row=rng.random((S, K)).astype(np.float32) * R,
        did_update=np.array([True, False, True, False]),
        refine_iters=np.array([3, 0, 0, 0], np.int32),
        maps=rng.random((S, R, R, K)).astype(np.float16),
        x0_pred=rng.standard_normal((S, LAT, LAT, 4)).astype(np.float16),
    )
    u8 = rng.integers(0, 256, (1, 8 * LAT, 8 * LAT, 3), dtype=np.uint8)
    return types.SimpleNamespace(diagnostics=d, images=u8.astype(np.float32) / 255.0,
                                 spec=types.SimpleNamespace(words=WORDS), prompt="a robot and a blue vase x",
                                 annotations=annotations)


def stub_pipes():
    jpipe = types.SimpleNamespace(sd=types.SimpleNamespace(decode_latents=stub_decode))
    tsd = types.SimpleNamespace(device=torch.device("cpu"),
                                config=types.SimpleNamespace(unet=types.SimpleNamespace(dtype=torch.float32)),
                                decode_latents=lambda t: torch.from_numpy(stub_decode(t.numpy())))
    return jpipe, types.SimpleNamespace(sd=tsd)


def tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("annotate", [False, True])
def test_run_artifacts_match_the_jax_package(tmp_path, annotate):
    jout = synthetic_output(jax_parse_prompt(META, {})[1])
    tout = synthetic_output(parse_prompt(META, {})[1])
    jpipe, tpipe = stub_pipes()
    kw = dict(seed=28, meta_prompt=META, annotate=annotate)
    jimg, jpath, jw = ja.write_run_artifacts(jpipe, jout, output_path=tmp_path / "jax", hp=JHP(), **kw)
    timg, tpath, tw = ta.write_run_artifacts(tpipe, tout, output_path=tmp_path / "port", hp=THP(), **kw)
    assert tw.async_writer.native

    jt, tt = tree(tmp_path / "jax"), tree(tmp_path / "port")
    assert tt == jt
    assert tpath.relative_to(tmp_path / "port") == jpath.relative_to(tmp_path / "jax")
    # the final image, 4 step maps (two words at two eval steps), 3 x0 preds, the run log
    assert sum(p.endswith(".png") for p in tt) == 1 + 4 + 3 and sum(p.endswith(".txt") for p in tt) == 1
    for rel in tt:
        j, t = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".txt"):
            assert t.read_text() == j.read_text(), rel
        else:
            np.testing.assert_array_equal(read_png(t), read_any(j), err_msg=rel)
    np.testing.assert_array_equal(timg, np.asarray(jimg))
    if annotate:  # the overlay really drew something
        assert (timg != np.round(tout.images[0] * 255)).any()


def test_grid_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(3)]
    jgrid = ja.image_grid([Image.fromarray(i) for i in imgs])
    ja.annotate_image(jgrid, jax_parse_prompt(META, {})[1], size=jgrid.size[0])
    tgrid = ta.image_grid(imgs)
    ta.annotate_image(tgrid, parse_prompt(META, {})[1], size=tgrid.shape[1])
    assert tgrid.shape == (128, 128, 3)
    np.testing.assert_array_equal(tgrid, np.asarray(jgrid))
    assert tnative.write_png(tgrid, tmp_path / "g.png")
    np.testing.assert_array_equal(read_png(tmp_path / "g.png"), tgrid)


@pytest.mark.parametrize("meta, size", [
    ("a [cat:0,0,1,1] and a [dog:.99,.01]", 64),  # box on the border, cross clipped at the corner
    ("a [cat:-.1,.5,.3,.7] and a [dog:.013,.987]", 96),  # box off the left, cross off two edges
    ("a [cat:.123,.456,.31,.27] and a [dog:.5,.5] and a [bird:.33,.1,.2,.2]", 512),  # fractional pixels
])
def test_annotate_matches_pillow(meta, size, monkeypatch, capsys):
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    jimg = Image.fromarray(img.copy())
    ja.annotate_image(jimg, jax_parse_prompt(meta, {})[1], size=size)
    jimg = np.asarray(jimg)
    timg = img.copy()
    ta.annotate_image(timg, parse_prompt(meta, {})[1], size=size)
    np.testing.assert_array_equal(timg, jimg)
    # without Pillow: the boxes and crosshairs alone, and a notice
    monkeypatch.setitem(sys.modules, "PIL", None)
    geometry = img.copy()
    ta.annotate_image(geometry, parse_prompt(meta, {})[1], size=size)
    assert "need Pillow" in capsys.readouterr().out
    drawn = (geometry != img).any(-1)
    assert drawn.sum() > 2 * size // 4  # boxes and crosshairs drawn
    # every box and crosshair pixel is Pillow's
    np.testing.assert_array_equal(geometry[drawn], jimg[drawn])


def test_native_writer_raises_on_failed_writes(tmp_path):
    """A queued write that fails (here: its path is a directory) makes the
    next flush raise, once; writes that succeed around it still land."""
    writer = tnative.AsyncArtifactWriter(2)
    (tmp_path / "taken.png").mkdir()
    m = np.arange(12, dtype=np.float32).reshape(3, 4)
    writer.submit_map(m, tmp_path / "a.png")
    writer.submit_map(m, tmp_path / "taken.png")
    writer.submit_image(np.zeros((4, 4, 3), np.uint8), tmp_path / "taken.png")
    with pytest.raises(OSError, match="failed to write 2 file"):
        writer.flush()
    writer.flush()  # the count starts again after each flush
    assert read_png(tmp_path / "a.png").shape == (3, 4, 3)
    writer.submit_map(m, tmp_path / "taken.png")
    with pytest.raises(OSError, match="failed to write 1 file"):
        writer.close()
    assert not writer.native


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_native_writer_maps_non_finite_values_to_level_0(tmp_path, bad):
    """The colormap's range is that of the finite values, and a value that
    is not finite takes level 0: the map writes as the same map with that
    pixel at its finite minimum."""
    rng = np.random.default_rng(3)
    m = rng.random((9, 11)).astype(np.float32)
    with_bad = m.copy()
    with_bad[4, 5] = bad
    at_min = m.copy()
    at_min[4, 5] = np.delete(m.ravel(), 4 * 11 + 5).min()
    writer = tnative.AsyncArtifactWriter(1)
    writer.submit_map(with_bad, tmp_path / "bad.png")
    writer.submit_map(at_min, tmp_path / "min.png")
    writer.close()
    got = read_png(tmp_path / "bad.png")
    np.testing.assert_array_equal(got, read_png(tmp_path / "min.png"))
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 50  # the finite values keep their spread


# ---- re-run dumps through the micro models, shared weights, float32 ----
# XLA:CPU compiles the micro UNet in 5 s with these, 11 s without
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def pipes():
    jsd = jax_micro_bundle()
    tsd = TSD.create("micro", torch.float32, device="cpu")
    tsd.load_jax_params(jax.tree_util.tree_map(np.asarray, jsd.params))
    return JPipe(jsd), TPipe(tsd)


def model_output(annotations):
    rng = np.random.default_rng(7)
    mask = np.zeros((3, R_SUB), bool)
    mask[0, [0, 4, R_SUB - 1]] = True
    mask[2, 0] = True
    d = types.SimpleNamespace(
        latent_in=rng.standard_normal((3, 16, 16, 4)).astype(np.float16),
        eval_latents=rng.standard_normal((3, R_SUB, 16, 16, 4)).astype(np.float16),
        eval_mask=mask,
    )
    return types.SimpleNamespace(diagnostics=d, prompt="a robot and a blue vase x", annotations=annotations)


class _Recording:
    """A writer that keeps each map it is handed, by file name."""

    def __init__(self, cls):
        self.inner = cls(2)
        self.maps = {}

    def submit_map(self, m, path, viridis=True):
        self.maps[Path(path).name] = np.array(m, np.float32)
        self.inner.submit_map(m, path, viridis)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def viridis_levels(tmp_path):
    """A function from a viridis PNG's pixels to their levels (0-255) in the
    writer's colormap, read back from a ramp the writer encodes."""
    writer = tnative.AsyncArtifactWriter(1)
    writer.submit_map(np.arange(256, dtype=np.float32)[None], tmp_path / "ramp.png")
    writer.close()
    table = {tuple(c): i for i, c in enumerate(read_png(tmp_path / "ramp.png")[0])}
    return lambda rgb: np.vectorize(lambda r, g, b: table[(r, g, b)])(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def assert_close_pngs(pairs, levels=lambda x: x):
    """Every pixel within one level of 255 (a map's level in the colormap),
    and at most 0.1% of all pixels off at all."""
    off = total = 0
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        diff = np.abs(levels(a).astype(np.int16) - levels(b).astype(np.int16))
        assert diff.max() <= 1, (name, diff.max())
        off += int((diff.reshape(a.shape[0], a.shape[1], -1) > 0).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    assert off <= 1e-3 * total, (off, total)


def test_individual_ca_maps_match_the_jax_package(pipes, tmp_path, monkeypatch):
    jp, tp = pipes
    jrec = _Recording(jnative.AsyncArtifactWriter)
    monkeypatch.setattr(jnative, "AsyncArtifactWriter", lambda n=2: jrec)
    # the JAX function applies the UNet eagerly, op by op (19 s of XLA:CPU
    # compiles of single ops here); the same apply, jitted, is one compile
    # (6 s at XLA's backend optimization level 0, 11 s at its default)
    sd = jp.sd
    unet = types.SimpleNamespace(apply=jax.jit(sd.unet.apply, static_argnames=("capture",), compiler_options=O0))
    jpipe = types.SimpleNamespace(sd=types.SimpleNamespace(unet=unet, params=sd.params, config=sd.config),
                                  encode_prompt=jp.encode_prompt)
    ja.save_individual_ca_maps(jpipe, model_output([]), step=12, heads_dir=tmp_path / "jax")
    trec = _Recording(tnative.AsyncArtifactWriter)
    ta.save_individual_ca_maps(tp, model_output([]), step=12, heads_dir=tmp_path / "port", async_writer=trec)
    trec.flush()
    # file names carry each head map's mean and max to 3 digits: compare
    # them through the maps, and the maps to 1e-4 of their largest value
    assert len(trec.maps) == len(jrec.maps) > 10
    jmaps = {k.split("_avg_")[0]: v for k, v in jrec.maps.items()}
    tmaps = {k.split("_avg_")[0]: v for k, v in trec.maps.items()}
    assert sorted(tmaps) == sorted(jmaps)
    for key, jm in jmaps.items():
        np.testing.assert_allclose(tmaps[key], jm, rtol=0, atol=1e-4 * float(np.abs(jm).max()), err_msg=key)
    jfiles = {p.name.split("_avg_")[0]: p for p in (tmp_path / "jax").iterdir()}
    tfiles = {p.name.split("_avg_")[0]: p for p in (tmp_path / "port").iterdir()}
    assert sorted(tfiles) == sorted(jfiles)
    assert_close_pngs([(key, read_png(tfiles[key]), read_any(jfiles[key])) for key in jfiles],
                      viridis_levels(tmp_path))


def test_diagnostic_preds_match_the_jax_package(pipes, tmp_path, monkeypatch):
    jp, tp = pipes
    jw = ja.ArtifactWriter(tmp_path / "jax", META, 28)
    tw = ta.ArtifactWriter(tmp_path / "port", META, 28)
    # the JAX function's programs (its CFG-forward-and-decode, the VAE
    # decode) compiled at XLA's backend optimization level 0: 10 s of
    # compile here where the default takes 20
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=O0))
    ja.save_diagnostic_preds(jp, model_output([]), jw, diagnostic_level=2)
    ta.save_diagnostic_preds(tp, model_output([]), tw, diagnostic_level=2)
    jt, tt = tree(tmp_path / "jax"), tree(tmp_path / "port")
    # four pred_pre_optim (one per evaluated slot) and two xt (one per eval step)
    assert tt == jt and len(tt) == 6
    assert_close_pngs([(rel, read_png(tmp_path / "port" / rel), read_any(tmp_path / "jax" / rel)) for rel in tt])
