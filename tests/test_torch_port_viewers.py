"""The port's offline viewers (``viewers/batch_map_view.py``,
``viewers/self_attn_clusters.py``) against the JAX package's, on the host.

One artifact tree, written by the port's ``write_run_artifacts`` from a
synthetic output (16x16 step maps of two words at four eval steps, the run
log), is read by both packages' ``collect_maps`` and
``parse_losses_from_log``, and plotted by both ``show_attn_plot`` into
PNGs: equal groups, images, losses and plot pixels. ``cluster_self_attention``
of one 256x256 matrix gives equal ks, inertias and silhouettes when numpy's
global seed is set the same before each call (KMeans with
``random_state=None`` draws its initial centres from it).
"""
import os
import shutil
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from guided_attention_tpu.viewers import batch_map_view as jbmv
from guided_attention_tpu.viewers import self_attn_clusters as jsac

from guided_attention_tpu_torch.annotation import parse_prompt
from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.runtime import artifacts as ta
from guided_attention_tpu_torch.viewers import batch_map_view as tbmv
from guided_attention_tpu_torch.viewers import self_attn_clusters as tsac

from test_torch_port_artifacts import META, WORDS, stub_pipes

S, R_SUB, K, R, LAT = 4, 6, 77, 16, 8


def synthetic_output(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((S, R_SUB), bool)
    mask[:, :3] = True
    mask[2, 3:] = True
    d = types.SimpleNamespace(
        total_loss=rng.random(S).astype(np.float32),
        eval_mask=mask,
        eval_unscaled=rng.random((S, R_SUB, K)).astype(np.float32),
        token_attn_sum=rng.random((S, K)).astype(np.float32),
        col=rng.random((S, K)).astype(np.float32) * R,
        row=rng.random((S, K)).astype(np.float32) * R,
        did_update=np.array([True, False, True, False]),
        refine_iters=np.array([3, 0, 5, 0], np.int32),
        maps=rng.random((S, R, R, K)).astype(np.float16),
        x0_pred=rng.standard_normal((S, LAT, LAT, 4)).astype(np.float16),
    )
    u8 = rng.integers(0, 256, (1, 8 * LAT, 8 * LAT, 3), dtype=np.uint8)
    return types.SimpleNamespace(diagnostics=d, images=u8.astype(np.float32) / 255.0,
                                 spec=types.SimpleNamespace(words=WORDS), prompt="a robot and a blue vase x",
                                 annotations=parse_prompt(META, {})[1])


@pytest.fixture(scope="module")
def seed_dir(tmp_path_factory):
    """A run's per-seed folder, with its run log beside it as
    ``<folder>.txt`` (where ``show_attn_plot`` reads the losses)."""
    root = tmp_path_factory.mktemp("viewers")
    _img, _path, writer = ta.write_run_artifacts(stub_pipes()[1], synthetic_output(), output_path=root, seed=28,
                                                 hp=HyperParams(), meta_prompt=META)
    folder = writer.step_dir
    shutil.copy(writer.run_dir / f"28{writer.hyper_suffix}.txt", str(folder) + ".txt")
    return str(folder)


@pytest.mark.parametrize("token", [None, "robot"])
def test_collect_maps_matches_the_jax_package(seed_dir, token):
    want, got = jbmv.collect_maps(seed_dir, token), tbmv.collect_maps(seed_dir, token)
    assert list(got) == list(want) == (["blue vase", "robot"] if token is None else ["robot"])
    for word in want:
        assert len(got[word]) == len(want[word]) == S
        for (gf, gi, git, gs), (wf, wi, wit, ws) in zip(got[word], want[word]):
            assert (gf, git, gs) == (wf, wit, ws)
            np.testing.assert_array_equal(gi, wi)
    assert [(it, sub) for _, _, it, sub in got["robot"]] == [("00", "02"), ("01", "02"), ("02", "05"), ("03", "02")]


@pytest.mark.parametrize("word", ["robot", "blue vase", "absent"])
def test_parse_losses_matches_the_jax_package(seed_dir, word):
    got, want = tbmv.parse_losses_from_log(seed_dir + ".txt", word), jbmv.parse_losses_from_log(seed_dir + ".txt", word)
    assert got == want
    assert len(got) == (0 if word == "absent" else S * 3 + 3)
    assert tbmv.parse_losses_from_log(seed_dir + ".missing", word) == {}


def test_saved_attention_plot_matches_the_jax_package(seed_dir, tmp_path):
    import matplotlib.pyplot as plt

    for mod, name in ((jbmv, "jax.png"), (tbmv, "port.png")):
        assert mod.show_attn_plot(seed_dir, "robot", view_losses=True, save_path=str(tmp_path / name)) is not None
    got, want = plt.imread(tmp_path / "port.png"), plt.imread(tmp_path / "jax.png")
    assert got.shape == want.shape and got.std() > 0
    np.testing.assert_array_equal(got, want)
    assert tbmv.show_attn_plot(str(tmp_path), save_path=str(tmp_path / "none.png")) is None


def test_self_attention_clusters_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((256, 256)) + 4.0 * (np.arange(256)[:, None] // 64 == np.arange(256)[None] // 64)
    attn = np.exp(scores) / np.exp(scores).sum(-1, keepdims=True)
    np.save(tmp_path / "attn.npy", attn.astype(np.float32))
    results = {}
    # one OpenMP thread: KMeans sums its inertia over thread chunks, and the
    # order of that float32 sum would change with the threads' schedule
    with threadpool_limits(1):
        for mod, name in ((jsac, "jax"), (tsac, "port")):
            os.makedirs(tmp_path / name)
            np.random.seed(0)
            results[name] = mod.cluster_self_attention(str(tmp_path / "attn.npy"), k_range=range(2, 5),
                                                       save_dir=str(tmp_path / name))
    assert results["port"] == results["jax"]
    assert results["port"][0] == [2, 3, 4]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
