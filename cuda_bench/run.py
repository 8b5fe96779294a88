"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m cuda_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything a cell is made of is found by
name from ``BENCHMARK.json``: the cell's configuration file (``file``), its
traffic mix ``cuda_bench/workloads/<traffic>.json``, which names its
driver ``cuda_bench/traffic/<driver>.py``, and each metric's reader
``cuda_bench/metrics/<metric>.py``. The run builds the port's
pipeline with weights drawn from the seed, warms up every shape the cell
uses, measures for ``--seconds``, checks what the window produced against
the plain reference (``cuda_bench/check.py``), and prints one JSON line
last on standard output. With ``--trace 1`` the window is measured the
same way and one further stretch of the traffic runs under the profiler;
the line then carries the per-layer metrics.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "guided_attention_tpu")


class NoDevice(RuntimeError):
    pass


def load_file(path: Path, name: str):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    bench: Dict
    entry: Dict
    config: Dict
    mix: Dict
    root: Path = ROOT

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        config = json.loads((root / conf["file"]).read_text())
        mix = json.loads((root / "cuda_bench" / "workloads" / f"{entry['traffic']}.json").read_text())
        return cls(bench, entry, config, mix, root)

    def metrics(self, kind: str) -> List[Dict]:
        """The cell's metrics of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.bench[kind] if self.entry["name"] in m.get("workloads", [self.entry["name"]])]


@dataclasses.dataclass
class Context:
    """What a traffic driver is handed."""

    pipe: Any
    recorder: Any
    mix: Dict
    seed: int
    seconds: float
    rng: np.random.Generator
    sd_2_1: bool
    device: torch.device
    state: Dict = dataclasses.field(default_factory=dict)
    window_start: Optional[float] = None
    closers: List[Callable] = dataclasses.field(default_factory=list)

    def mark_window_start(self, t: float) -> None:
        if self.window_start is None:
            self.window_start = t

    def on_close(self, fn: Callable) -> None:
        self.closers.append(fn)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def profile_ctx(modules: Dict, out: Dict):
    """A context manager running its block under ``torch.profiler`` (CPU and
    CUDA) with the module ranges on, and reading the trace into ``out``."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from cuda_bench import trace

    @contextlib.contextmanager
    def run():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with trace.module_ranges(modules):
                yield
            torch.cuda.synchronize()
        events, kernels, graph_launches = trace.read(prof)
        del prof
        out.update(events=events, kernels=kernels, graph_launches=graph_launches, busy_us=trace.busy_us(kernels),
                   summary=trace.summarize(events, kernels))

    return run


def check(cell: Cell, ctx: Context, result: Dict, weights, control: bool = False) -> Dict[str, float]:
    """The numbers compared (``check.NUMBERS``), worst over the window."""
    from cuda_bench import check as chk
    from cuda_bench.reference.model import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = chk.Loop.of(cell.mix["knobs"])
    checker = chk.Checker(loop, ctx.device, control=control)
    batches = result["batches"]
    ok = {bi: checker.chain(b, bi) for bi, b in enumerate(batches)}
    ref = Reference(cell.config["arch"], weights, ctx.device)
    res = cell.config["arch"]["attention_res"]
    specs: Dict[str, Any] = {}

    def spec_of(prompt):
        if prompt not in specs:
            specs[prompt] = ref.spec(prompt, res, ctx.sd_2_1)
        return specs[prompt]

    def final_loss(out):
        return float(np.asarray(out.diagnostics.total_loss)[max(loop.guided_steps)])

    rows = [(bi, b) for bi, b in chk.sample_rows(batches, cell.mix["check_rows"], ctx.rng) if ok[bi]]
    for bi, b in rows:
        checker.reference_row(ref, batches[bi], bi, b, spec_of, cell.config["arch"]["scaling_factor"], final_loss)
    del ref
    return {"numbers": checker.worst, "notes": checker.notes, "rows_checked": len(rows)}


def cuda_device(cell: Cell) -> torch.device:
    """The card the run measures; raises ``NoDevice`` without enough of them."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark measures the port on a CUDA device")
    if torch.cuda.device_count() < cell.entry["chips"]:
        raise NoDevice(f"the cell asks for {cell.entry['chips']} devices, {torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from guided_attention_tpu_torch.ops import build

    build.load_library()  # nvcc builds the port's kernels on a checkout's first run
    return device


def measure(cell: Cell, seed: int, seconds: float, trace_on: bool, device: torch.device,
            control: bool = False) -> Dict:
    """One run of ``cell`` on ``device``: setup, window, [traced stretch], check."""
    from cuda_bench import record, system

    t_build = time.perf_counter()
    pipe, weights = system.build(cell.config, seed, device)
    t_weights = time.perf_counter()
    recorder = record.Recorder(pipe.sd.unet)
    driver = load_file(cell.root / "cuda_bench" / "traffic" / f"{cell.mix['driver']}.py",
                       f"cuda_bench.traffic.{cell.mix['driver']}")
    ctx = Context(pipe, recorder, cell.mix, seed, seconds, np.random.default_rng(seed), cell.config["sd_2_1"], device)
    try:
        driver.warmup(ctx)
        result = driver.run(ctx)
        traced = None
        if trace_on:
            prof: Dict = {}
            modules = {"unet": pipe.sd.unet, "text_encoder": pipe.sd.text_encoder, "vae": pipe.sd.vae}
            traced = driver.traced(ctx, profile_ctx(modules, prof))
            traced.update(prof)
    finally:
        for fn in ctx.closers:
            fn()
        recorder.close()
    print(f"cuda_bench: setup: {t_build - PROCESS_START:.3f} s to the library, {t_weights - t_build:.3f} s weights, "
          f"{ctx.window_start - t_weights:.3f} s warm-up", file=sys.stderr)
    dev = device_info(cell.entry["chips"]) if device.type == "cuda" else {"platform": "cpu"}
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = check(cell, ctx, result, weights, control)
    return {"setup_s": ctx.window_start - PROCESS_START, "result": result, "traced": traced, "device": dev,
            "check": checked, "config": cell.config, "mix": cell.mix}


def read_metrics(cell: Cell, run: Dict, kind: str) -> Dict[str, Dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics, each from its
    reader ``cuda_bench/metrics/<name>.py``; one that finds nothing to
    read is left out."""
    out = {}
    for m in cell.metrics(kind):
        reader = load_file(cell.root / "cuda_bench" / "metrics" / f"{m['name']}.py", f"cuda_bench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(cell: Cell, run: Dict):
    """(correct, {number: {"value", "limit"}}) against the configuration's limits."""
    limits = cell.config["limits"]
    nums = run["check"]["numbers"]
    checks = {n: {"value": nums[n], "limit": limits[n]} for n in limits}
    r = run["result"]
    correct = (all(c["value"] <= c["limit"] for c in checks.values()) and r["failed"] == 0
               and run["check"]["rows_checked"] > 0)
    return correct, checks


def main(argv=None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.load(args.workload, root)
    try:
        device = cuda_device(cell)
    except NoDevice as e:
        print(f"cuda_bench: {e}", file=sys.stderr)
        return 3
    run = measure(cell, args.seed, args.seconds, bool(args.trace), device)
    correct, checks = verdict(cell, run)
    r = run["result"]
    line = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"]}
    if args.trace:
        t = run["traced"]
        line["metrics"] = read_metrics(cell, run, "per_layer")
        device = dict(run["device"], busy_s=t["busy_us"] / 1e6, window_s=t["wall_s"])
        line["device"] = device
        line["breakdown"] = {"device_ops": t["summary"]["device_ops"], "idle_gaps": t["summary"]["idle_gaps"]}
    else:
        line["metrics"] = read_metrics(cell, run, "end_to_end")
        line["device"] = run["device"]
    line["checks"] = checks
    notes = run["check"]["notes"]
    for note in [n for n in notes[:-12] if "kink" in n] + notes[-12:]:  # every gradient judged past a kink
        print(f"cuda_bench: worst so far: {note}", file=sys.stderr)
    if r.get("errors"):
        print(f"cuda_bench: {len(r['errors'])} failed requests, first: {r['errors'][0]}", file=sys.stderr)
    found = forbidden_modules()  # after everything this process loads: the check, the reference, the readers
    if found:
        print(f"cuda_bench: modules loaded that the benchmark's process must not hold: {found}", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:g})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
