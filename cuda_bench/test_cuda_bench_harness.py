"""The harness's arithmetic and form, on the CPU, without the card."""
from __future__ import annotations

import ast
import io
import json
import statistics
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cuda_bench import record, run as R
from cuda_bench.traffic import common, open_loop_serve, sweep

BENCH_DIR = Path(__file__).resolve().parent


# --- traffic ---------------------------------------------------------------


def test_open_loop_schedule_is_seeded_and_keeps_its_gaps():
    a = open_loop_serve.arrivals(0.65, 51.0, np.random.default_rng(7))
    b = open_loop_serve.arrivals(0.65, 51.0, np.random.default_rng(7))
    c = open_loop_serve.arrivals(0.65, 51.0, np.random.default_rng(8))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(a) == len(c) == round(0.65 * 51)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 51.0
    # gaps of one fixed set in another order: the schedule's spread does not depend on the seed
    g = open_loop_serve.gaps(0.65, 51.0)
    for due in (a, c):
        d = np.diff(due)
        assert np.all(np.isclose(d[:, None], g[None, :]).any(axis=1))
        assert len(set(np.round(d, 9))) == len(d)


def test_layouts_are_seeded_with_fixed_sizes():
    mix = {"objects": [{"word": "robot", "size": [0.4, 0.55]}, {"word": "blue vase", "size": [0.4, 0.55]}]}
    p1 = common.layout(np.random.default_rng(3), mix)
    assert p1 == common.layout(np.random.default_rng(3), mix)
    assert p1 != common.layout(np.random.default_rng(4), mix)
    assert p1.startswith("a [robot:") and "a [blue vase:" in p1 and p1.count(",0.4,0.55]") == 2


class _FakeRecorder:
    def __init__(self):
        self.batches = []

    def begin(self, seeds, prompts):
        self.batches.append(record.Batch(list(seeds), list(prompts)))
        return self.batches[-1]

    def end(self):
        pass


class _FakePipe:
    """Each batch takes ``dt`` seconds, the third ``stall`` seconds."""

    def __init__(self, dt, stall):
        self.dt, self.stall, self.calls = dt, stall, []

    def dispatch_batch(self, seeds, meta_prompt=None, **kw):
        self.calls.append(list(seeds))
        wait = self.stall if len(self.calls) == 3 else self.dt
        return SimpleNamespace(result=lambda: (time.sleep(wait), [SimpleNamespace(seed=s) for s in seeds])[1])


def _sweep_ctx(pipe, seconds):
    mix = {"batch": 4, "objects": [{"word": "robot", "size": [0.4, 0.55]}], "knobs": {"num_inference_steps": 2}}
    return R.Context(pipe, _FakeRecorder(), mix, 5, seconds, np.random.default_rng(5), False, torch.device("cpu"))


def test_sweep_sends_successive_seeds_and_rates_over_all_the_time():
    pipe = _FakePipe(0.05, 0.4)
    ctx = _sweep_ctx(pipe, 0.5)
    out = sweep.run(ctx)
    seeds = [s for c in pipe.calls for s in c]
    assert seeds == list(range(seeds[0], seeds[0] + len(seeds)))  # successive, from the seed
    assert out["images"] == 4 * len(pipe.calls)
    # the stall is inside the window: the rate is every image over all the time to the last batch's end
    assert out["window_s"] >= 0.4 + 2 * 0.05
    assert out["window_s"] == pytest.approx(out["batches"][-1].end - ctx.window_start)
    assert sum(out["batch_walls"]) <= out["window_s"]
    cell = SimpleNamespace(root=R.ROOT, metrics=lambda kind: [{"name": "images_per_s", "unit": "images/s"},
                                                              {"name": "setup_s", "unit": "s"}])
    e2e = R.read_metrics(cell, {"result": out, "setup_s": 1.0}, "end_to_end")
    assert e2e["images_per_s"]["value"] == pytest.approx(out["images"] / out["window_s"])
    # against a median of batches, which the stall would not move
    assert e2e["images_per_s"]["value"] < 4 / statistics.median(out["batch_walls"])


def test_latency_median_and_serving_counters():
    cell = SimpleNamespace(root=R.ROOT, metrics=lambda kind: [{"name": "latency_p50_s.serve", "unit": "s"},
                                                              {"name": "served_images_per_s", "unit": "images/s"}])
    run = {"result": {"latencies": [3.0, 1.0, 2.0, 10.0], "window_s": 16.0}, "setup_s": 1.0}
    got = R.read_metrics(cell, run, "per_layer")
    assert got["latency_p50_s.serve"]["value"] == 2.5
    # every request due in the window over the time to the last delivery
    assert got["served_images_per_s"]["value"] == 0.25
    assert R.read_metrics(cell, {"result": {"images": 8, "window_s": 9.0}}, "end_to_end") == {}
    fill = R.load_file(BENCH_DIR / "metrics" / "serve_fill.py", "m_fill")
    group = R.load_file(BENCH_DIR / "metrics" / "serve_group_mean.py", "m_group")
    stats = {"result": {"stats": {"requests": 9, "samples": 12, "padded_samples": 3, "batches": 3, "errors": 0}}}
    assert fill.read(stats) == pytest.approx(75.0)
    assert group.read(stats) == pytest.approx(3.0)
    assert fill.read({"result": {}}) is None


def test_padding_rows_are_found():
    b = record.Batch([5, 6, 7, 7], ["p", "q", "r", "r"])
    assert open_loop_serve._padding(b) == 1
    assert open_loop_serve._padding(record.Batch([5, 6], ["p", "q"])) == 0


# --- the run's form -----------------------------------------------------------


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = R.main(["--workload", "sd15-sweep-b8", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "is_available() is False" in out.err


def test_last_line_form(monkeypatch):
    cell = R.Cell.load("sd15-sweep-b8")
    limits = {n: 1.0 for n in ("init_max_abs", "state_rel", "eps_rel")}
    monkeypatch.setattr(R.Cell, "load", classmethod(lambda cls, name, root=None: R.Cell(
        cell.bench, cell.entry, dict(cell.config, limits=limits), cell.mix)))
    monkeypatch.setattr(R, "cuda_device", lambda c: torch.device("cpu"))
    monkeypatch.setattr(R, "device_info", lambda n: {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n,
                                                     "memory_peak_bytes": 1})
    run = {"setup_s": 12.5, "device": R.device_info(1),
           "result": {"images": 16, "window_s": 20.0, "attempted": 16, "failed": 0},
           "check": {"numbers": {"init_max_abs": 0.0, "state_rel": 0.5, "eps_rel": 2.0}, "notes": [], "rows_checked": 2}}
    monkeypatch.setattr(R, "measure", lambda *a, **k: run)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = R.main(["--workload", "sd15-sweep-b8", "--seed", str(2**31 + 5), "--seconds", "20"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is False  # eps_rel 2.0 over its limit 1.0
    assert line["metrics"] == {"images_per_s": {"value": 0.8, "unit": "images/s"},
                               "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["checks"]["eps_rel"] == {"value": 2.0, "limit": 1.0}
    assert err.getvalue().strip().splitlines()[-1].startswith("check eps_rel: 2")


def test_no_line_when_a_reader_loads_jax_or_flax(tmp_path, monkeypatch):
    """The guard looks at ``sys.modules`` last, after the check and every
    reader have run: a reader that pulls in flax leaves no result."""
    from cuda_bench.conftest import micro_root

    root = micro_root(tmp_path)
    monkeypatch.setattr(R, "cuda_device", lambda c: torch.device("cpu"))
    run = {"setup_s": 1.0, "device": {"platform": "cpu"}, "result": {"images": 2, "window_s": 1.0, "attempted": 2,
                                                                      "failed": 0},
           "check": {"numbers": {n: 0.0 for n in R.Cell.load("micro-sweep", root).config["limits"]}, "notes": [],
                     "rows_checked": 1}}
    monkeypatch.setattr(R, "measure", lambda *a, **k: run)
    argv = ["--workload", "micro-sweep", "--seed", "3", "--seconds", "1"]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert R.main(argv, root) == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is True
    (root / "cuda_bench" / "metrics" / "dummy.flax.py").write_text(
        "import sys\nimport types\n\n"
        "sys.modules.setdefault('flax.x', types.ModuleType('flax.x'))  # as an import of flax.x would\n\n\n"
        "def read(run):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "dummy.flax", "unit": "1", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["micro-sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = R.main(argv, root)
    finally:
        sys.modules.pop("flax.x", None)
    assert rc == 4 and out.getvalue() == "" and "flax" in err.getvalue()


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "guided_attention_tpu_torch_x", SimpleNamespace())
    assert "guided_attention_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", SimpleNamespace())
    assert "flax" in R.forbidden_modules()


# --- driven by data -----------------------------------------------------------


def test_a_new_metric_and_cell_need_only_files_and_entries(tmp_path):
    from cuda_bench.conftest import micro_root

    root = micro_root(tmp_path)
    (root / "cuda_bench" / "metrics" / "dummy.count.py").write_text(
        "def read(run):\n    return float(len(run['result']['batches']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy.count", "unit": "batches", "better": "higher", "source": "program_counter",
                               "layer": "loop", "moves": "images_per_s", "workloads": ["micro-sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = R.Cell.load("micro-sweep", root)
    assert cell.mix["driver"] == "sweep" and cell.config["preset"] == "micro"
    names = [m["name"] for m in cell.metrics("per_layer")]
    assert "dummy.count" in names and "serve_fill" not in names
    batches = [record.Batch([k], ["a [robot:0,0,0.4,0.55]"]) for k in range(3)]
    got = R.read_metrics(cell, {"result": {"batches": batches, "images": 3, "window_s": 1.0}, "traced": None,
                             "config": cell.config}, "per_layer")
    assert got["dummy.count"] == {"value": 3.0, "unit": "batches"}


# --- isolation -----------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_isolation(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "guided_attention_tpu", "bench"}, tops
    if "reference" in path.relative_to(BENCH_DIR).parts:
        assert "guided_attention_tpu_torch" not in tops
        assert tops <= {"__future__", "dataclasses", "hashlib", "math", "typing", "numpy", "torch", "cuda_bench"}
