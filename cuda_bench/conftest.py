"""pytest settings of the benchmark's own tests.

    python -m pytest cuda_bench -q

The ``card`` marker marks tests that run only where CUDA is: each asks for
the ``card`` fixture, which skips without one (decided when the test runs,
never when the module is imported). On the card:
``python -m pytest cuda_bench -q -m card``.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

MICRO = {
    "name": "micro", "source": "tests", "preset": "micro", "dtype": "float32", "sd_2_1": False,
    "arch": {
        "unet": {"sample_size": 16, "in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64, 64],
                 "layers_per_block": 1, "cross_attention_dim": 64, "num_heads": [2, 2, 2, 2],
                 "attn_down": [True, True, True, False], "use_linear_projection": False, "norm_num_groups": 8},
        "clip": {"vocab_size": 49408, "hidden_size": 64, "num_layers": 2, "num_heads": 2, "intermediate_size": 128,
                 "max_position_embeddings": 77, "hidden_act": "quick_gelu"},
        "vae": {"block_out_channels": [16, 16, 32, 32], "layers_per_block": 1, "norm_num_groups": 8},
        "scaling_factor": 0.18215, "latent_size": 16, "image_size": 128, "attention_res": 16},
}
OBJECTS = [{"word": "robot", "size": [0.4, 0.55]}, {"word": "blue vase", "size": [0.4, 0.55]}]
KNOBS = {"num_inference_steps": 3, "thresholds": {"0": 1.0}, "guidance_scale": 7.5}
MIXES = {
    "tiny-sweep": {"driver": "sweep", "batch": 2, "objects": OBJECTS, "knobs": KNOBS, "warmup_steps": 2,
                   "check_rows": 2},
    "tiny-serve": {"driver": "open_loop_serve", "rate_per_s": 2.0, "buckets": [1, 2], "max_wait_ms": 150,
                   "objects": OBJECTS, "knobs": KNOBS, "warmup_steps": 2, "check_rows": 2, "drain_timeout_s": 120,
                   "trace_seconds": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the test runs on the card")
    return torch.device("cuda", 0)


def micro_root(tmp: Path) -> Path:
    """A checkout in ``tmp``: the benchmark's files, and a BENCHMARK.json
    with the micro configuration (under the sd15 limits) and a sweep and a
    serving cell of it beside the real ones."""
    shutil.copytree(ROOT / "cuda_bench", tmp / "cuda_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    micro = dict(MICRO, limits=json.loads((ROOT / "cuda_bench" / "configs" / "sd15.json").read_text())["limits"])
    (tmp / "cuda_bench" / "configs" / "micro.json").write_text(json.dumps(micro))
    for name, mix in MIXES.items():
        (tmp / "cuda_bench" / "workloads" / f"{name}.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "micro", "source": "tests", "file": "cuda_bench/configs/micro.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"] += [
        {"name": "micro-sweep", "config": "micro", "traffic": "tiny-sweep", "chips": 1, "why": "tests"},
        {"name": "micro-serve", "config": "micro", "traffic": "tiny-serve", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("sd15-sweep-b8", "micro-sweep"), ("sd15-serve-poisson", "micro-serve")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def micro(tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return micro_root(tmp_path)
