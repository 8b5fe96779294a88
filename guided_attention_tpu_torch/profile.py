"""Where the device time of one guided generation goes: by kernel family,
and by the module and op that launched each kernel.

    python -m guided_attention_tpu_torch.profile [--batch] [--device cuda|cpu]
        [--model sd15|sd21|micro] [--steps 50]
    python -m guided_attention_tpu_torch.profile --analyze chiprun_out/profile_ops.json

Runs the main path (``workload.py``: guided 512x512 SD1.5, 50 steps, bf16,
on the CUDA device), or with ``--batch`` the batch path
(``workload.generate_batch``: ``BATCH_SEEDS`` under the two
``BATCH_PROMPTS``, B = 4 images per call): one warm-up call on the card,
then one call under ``torch.profiler`` (CPU and CUDA activities), and
prints one JSON line: wall seconds, summed device kernel time and kernel
launches (in all and per image), the device's busy share, and kernel time
by family (the port's three kernels, convolutions, matrix products, norms,
...). The full table goes to ``chiprun_out/profile.json``
(``profile_batch.json``).

The breakdown by op and module (the counterpart of the JAX package's HLO
join in ``scripts/profile_guided.py``, which named each fused op): during
the profiled call every module of the bundle (UNet, CLIP, VAE) runs inside
a ``record_function`` range named by its dotted path (forward hooks), and
every call of a port function outside the modules inside one named by its
file, line and name (a profile function of the interpreter,
``sys.setprofile``: PyTorch's ``with_stack`` frames are not among the
events of every version, 2.11's for one); both are put on for that call
and taken off after it. Each kernel is then joined to the op that launched
it (the profiler's correlation of a CPU event with its kernels) and to the
innermost module range around that op; a backward kernel to the forward
module of its autograd node (the forward op with the node's
``sequence_nr`` on the forward thread); a kernel outside every module to
the innermost port function around its op (guidance losses, smoothing,
DDIM and the loop's casts are not modules). What nothing attributes is counted under ``unattributed``,
never dropped, and the join must close: per family, the rows add up to the
family's total within ``CLOSE_REL`` in time and exactly in launches. Prints
per family the top (module, op) keys by time and by launches, and
copy/cast and other in full by module kind and op; the joined table goes to
``chiprun_out/profile_ops.json`` (``profile_ops_batch.json``), which
``--analyze FILE`` prints again without running anything.

On ``--device cpu`` (``--model micro`` for a quick drive) there is no
device time: the same join attributes each aten op's own CPU time, so that
it can be checked on the CPU, and the device fields read as not measured.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from guided_attention_tpu_torch import workload

OUT_DIR = "chiprun_out"

# first matching substring (lower-cased kernel name) names the family
FAMILIES = (
    ("k1_flash_self_fwd", ("flash_self_fwd",)),
    ("k2_flash_self_bwd", ("dkdv_kernel", "dq_kernel")),
    ("k3_cross_map", ("cross_map_kernel",)),
    ("conv", ("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad", "nhwc", "nchw")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90", "matmul")),
    ("norm", ("group_norm", "layer_norm", "norm")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy_cast", ("copy", "cast", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized")),
)
# the families the breakdown prints in full
FULL_FAMILIES = ("copy_cast", "other")

MODULE_PREFIX = "module: "  # the record_function range of a module, by its dotted path
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "  # an autograd node run in the backward
SOURCE_PREFIX = "src: "  # the record_function range of a port function's call, "file(line): name"
PORT_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
UNATTRIBUTED = "unattributed"
DIRECT = "(launched by the module's own code)"  # a kernel whose innermost range is a module's
NOT_LINKED = "(no launching op)"  # a kernel the profiler tied to no CPU event
CLOSE_REL = 0.005


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


# ---------------------------------------------------------------------------
# the join
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Event:
    """A CPU event of the profile: an op, or a ``record_function`` range
    (a module's, a port function's)."""

    name: str
    parent: Optional[int] = None  # index of the innermost event around it on its thread
    start: float = 0.0  # us
    thread: int = 0
    seq: int = -1  # autograd sequence number: a forward op's node, or the node a backward event runs
    fwd_thread: int = 0  # a backward event's forward thread
    work: Tuple[Tuple[str, float], ...] = ()  # (kernel, us) it launched; on the CPU its own (op, us)


def is_device_work(e) -> bool:
    """Whether a raw CUDA event of the profiler is work the device ran (a
    kernel, a copy, a fill) and not the device-side span of a
    ``record_function`` range, which spans the kernels launched inside it."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return "annotation" not in str(kind) and not e.name().startswith((MODULE_PREFIX, SOURCE_PREFIX))


class Join:
    """Attributes each event's work to (module, op), with memoized contexts:
    the innermost module range around an event, else the innermost port
    function's range, and whether it runs in a backward."""

    def __init__(self, events: Sequence[Event]):
        self.events = events
        self.memo: Dict[int, Tuple[Optional[str], Optional[str], bool]] = {}
        in_bwd = [None] * len(events)
        for i in range(len(events)):
            self._in_backward(i, in_bwd)
        # forward events with a sequence number, per (thread, seq), by start
        self.forward: Dict[Tuple[int, int], List[Tuple[float, int]]] = {}
        for i, e in enumerate(events):
            if e.seq >= 0 and not in_bwd[i]:
                self.forward.setdefault((e.thread, e.seq), []).append((e.start, i))
        for lst in self.forward.values():
            lst.sort()

    def _in_backward(self, i: int, in_bwd: list) -> bool:
        chain = []
        j = i
        while j is not None and in_bwd[j] is None:
            chain.append(j)
            if self.events[j].name.startswith(BACKWARD_PREFIX):
                in_bwd[j] = True
                chain.pop()
                break
            j = self.events[j].parent
        value = bool(j is not None and in_bwd[j])
        for k in chain:
            in_bwd[k] = value
        return value

    def forward_of(self, i: int) -> Optional[int]:
        """The forward op of backward event ``i``'s autograd node: of the
        forward events with its sequence number on its forward thread, the
        last to start before it (the op that made the node; an op before it
        that made no node reads the same number)."""
        e = self.events[i]
        lst = self.forward.get((e.fwd_thread or e.thread, e.seq), [])
        k = bisect.bisect_left(lst, (e.start, -1)) - 1
        return lst[k][1] if k >= 0 else None

    def context(self, i: Optional[int]) -> Tuple[Optional[str], Optional[str], bool]:
        """(module path or None, innermost port function or None, backward)
        around event ``i``, itself included."""
        if i is None:
            return None, None, False
        if i in self.memo:
            return self.memo[i]
        e = self.events[i]
        if e.name.startswith(MODULE_PREFIX):
            out = (e.name[len(MODULE_PREFIX):], None, False)
        elif e.name.startswith(BACKWARD_PREFIX) and e.seq >= 0:
            module, source, _bwd = self.context(self.forward_of(i))
            out = (module, source, True)
        else:
            module, source, bwd = self.context(e.parent)
            if module is None and e.name.startswith(SOURCE_PREFIX):
                source = e.name[len(SOURCE_PREFIX):]  # the innermost port function wins
            out = (module, source, bwd)
        self.memo[i] = out
        return out

    def key(self, i: int) -> Tuple[str, str, bool]:
        """(module path, or "src: <function>", or ``UNATTRIBUTED``; op; backward)."""
        module, source, bwd = self.context(i)
        name = self.events[i].name
        op = DIRECT if name.startswith(MODULE_PREFIX) else name
        if module is not None:
            return module, op, bwd
        if source is not None:
            return SOURCE_PREFIX + source, op, bwd
        return UNATTRIBUTED, op, bwd


def join(events: Sequence[Event], totals: Dict[str, Tuple[float, int]], kinds: Dict[str, str]) -> dict:
    """Join every kernel (or, on the CPU, every op) of ``events``' work to
    its (module, op) and hold the rows against ``totals`` ({name: (us,
    count)}, the profiler's own sums by kernel name). A kernel counted in
    the totals that no event launched goes to ``UNATTRIBUTED`` under
    ``NOT_LINKED``. Returns {"rows", "families", "closes"}, ms and launches
    per row, the rows sorted by ms."""
    j = Join(events)
    rows: Dict[Tuple[str, str, str, bool], List[float]] = {}
    linked: Dict[str, List[float]] = {}
    fam_of: Dict[str, str] = {}
    for i, e in enumerate(events):
        if not e.work:
            continue
        module, op, bwd = j.key(i)
        for kname, us in e.work:
            fam = fam_of.get(kname) or fam_of.setdefault(kname, family(kname))
            r = rows.setdefault((fam, module, op, bwd), [0.0, 0])
            r[0] += us
            r[1] += 1
            lk = linked.setdefault(kname, [0.0, 0])
            lk[0] += us
            lk[1] += 1
    for kname, (us, count) in totals.items():
        got_us, got_n = linked.get(kname, (0.0, 0))
        if count > got_n:
            r = rows.setdefault((family(kname), UNATTRIBUTED, NOT_LINKED, False), [0.0, 0])
            r[0] += max(us - got_us, 0.0)
            r[1] += count - got_n
    fams: Dict[str, dict] = collections.defaultdict(lambda: {
        "ms": 0.0, "launches": 0, "rows_ms": 0.0, "rows_launches": 0, "unattributed_ms": 0.0,
        "unattributed_launches": 0})
    for kname, (us, count) in totals.items():
        f = fams[family(kname)]
        f["ms"] += us / 1e3
        f["launches"] += count
    out_rows = []
    for (fam, module, op, bwd), (us, n) in rows.items():
        f = fams[fam]
        f["rows_ms"] += us / 1e3
        f["rows_launches"] += n
        if module == UNATTRIBUTED:
            f["unattributed_ms"] += us / 1e3
            f["unattributed_launches"] += n
        out_rows.append({"family": fam, "module": module, "kind": kinds.get(module, module), "op": op, "backward": bwd,
                         "ms": us / 1e3, "launches": n})
    for f in fams.values():
        f["closes"] = (abs(f["rows_ms"] - f["ms"]) <= CLOSE_REL * max(f["ms"], 1e-9)
                       and f["rows_launches"] == f["launches"])
    out_rows.sort(key=lambda r: -r["ms"])
    return {"rows": out_rows, "families": dict(sorted(fams.items(), key=lambda kv: -kv[1]["ms"])),
            "closes": all(f["closes"] for f in fams.values())}


def events_from_profiler(prof, cuda: bool) -> Tuple[List[Event], Dict[str, Tuple[float, int]]]:
    """The profile's CPU events as ``Event``s, nested by time on each
    thread (each op's kernels as its work on CUDA; each aten op's own CPU
    time on the CPU), and the totals by name ({name: (us, count)}) of every
    CUDA kernel, or of every aten op. Reads the profiler's raw events
    (``kineto_results``): its ``events()`` list would build a Python object
    per event first, minutes at the million events of a call."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    raw = results.events()
    kind = type(raw[0]) if raw else object
    hidden = getattr(kind, "is_hidden_event", lambda e: False)
    cpu_type, cuda_type = DeviceType.CPU, DeviceType.CUDA
    cpu, device = [], []
    for e in raw:
        dtype = e.device_type()
        if dtype == cpu_type:
            # the runtime's launch calls carry the op's correlation; the op is what counts
            if e.linked_correlation_id() > 0 or e.is_async() or hidden(e):
                continue
            cpu.append((e.start_thread_id(), e.start_ns() - t0, t0 - e.end_ns(), e.name(), e.sequence_nr(),
                        e.fwd_thread_id(), e.correlation_id()))
        elif dtype == cuda_type and cuda and not hidden(e) and is_device_work(e):
            device.append((e.linked_correlation_id(), e.name(), e.duration_ns() / 1e3))
    del raw
    cpu.sort(key=lambda c: c[:3])  # by thread, start, then the longest first
    events: List[Event] = []
    by_corr: Dict[int, int] = {}
    around: List[int] = []  # the events open at the current one, innermost last
    ends: List[int] = []  # ns from the trace's start, as the starts
    spans: List[int] = []
    for thread, start, neg_end, name, seq, fwd_thread, corr in cpu:
        while around and (events[around[-1]].thread != thread or ends[around[-1]] <= start):
            around.pop()
        i = len(events)
        events.append(Event(name, around[-1] if around else None, start / 1e3, thread, seq, fwd_thread))
        ends.append(-neg_end)
        spans.append(-neg_end - start)
        around.append(i)
        if corr > 0:
            by_corr[corr] = i
    totals: Dict[str, List[float]] = {}
    if cuda:
        work: Dict[int, list] = {}
        for corr, name, us in device:
            t = totals.setdefault(name, [0.0, 0])
            t[0] += us
            t[1] += 1
            if corr in by_corr:
                work.setdefault(by_corr[corr], []).append((name, us))
        for i, w in work.items():
            events[i].work = tuple(w)
    else:  # an aten op's own time: its span less its children's
        own = list(spans)
        for i, e in enumerate(events):
            if e.parent is not None:
                own[e.parent] -= spans[i]
        for i, e in enumerate(events):
            if e.name.startswith("aten::"):
                e.work = ((e.name, own[i] / 1e3),)
                t = totals.setdefault(e.name, [0.0, 0])
                t[0] += own[i] / 1e3
                t[1] += 1
    return events, {name: (us, n) for name, (us, n) in totals.items()}


@contextlib.contextmanager
def attribution_ranges(sd):
    """For the time of the block, every module of the bundle runs inside a
    ``record_function`` range named ``MODULE_PREFIX`` + its dotted path
    ("unet.down_blocks.0...", "text_encoder...", "vae...") and every call
    of a port function made outside the modules inside one named
    ``SOURCE_PREFIX`` + "file(line of its def): name" (file relative to the
    package); the hooks and the interpreter's profile function come off
    after it. Yields {module path: class name}."""
    from torch.autograd.profiler import record_function

    handles, kinds, open_modules = [], {}, []

    def enter(_mod, _args, name):
        rf = record_function(name)
        rf.__enter__()
        open_modules.append(rf)

    def leave(_mod, _args, _out):
        open_modules.pop().__exit__(None, None, None)

    for component in ("unet", "text_encoder", "vae"):
        for path, mod in getattr(sd, component).named_modules(prefix=component):
            kinds[path] = type(mod).__name__
            handles.append(mod.register_forward_pre_hook(functools.partial(enter, name=MODULE_PREFIX + path)))
            handles.append(mod.register_forward_hook(leave, always_call=True))

    open_calls: list = []  # (frame, range) of the port's calls now open, innermost last
    names: Dict[object, Optional[str]] = {}  # code object: its range's name, None off the port

    def calls(frame, event, _arg):
        if event == "call" and not open_modules:
            code = frame.f_code
            name = names.get(code, "")
            if name == "":
                name = names[code] = (SOURCE_PREFIX + f"{code.co_filename[len(PORT_DIR):]}({code.co_firstlineno}): "
                                      f"{code.co_name}" if code.co_filename.startswith(PORT_DIR) else None)
            if name is not None:
                rf = record_function(name)
                rf.__enter__()
                open_calls.append((frame, rf))
        elif event == "return" and open_calls and open_calls[-1][0] is frame:
            open_calls.pop()[1].__exit__(None, None, None)

    previous = sys.getprofile()
    sys.setprofile(calls)
    try:
        yield kinds
    finally:
        sys.setprofile(previous)
        while open_calls:
            open_calls.pop()[1].__exit__(None, None, None)
        for h in handles:
            h.remove()


# ---------------------------------------------------------------------------
# one profiled call
# ---------------------------------------------------------------------------


def run(pipe, batch: bool = False, steps: int = workload.STEPS, warmup: bool = True) -> dict:
    """One warm-up call on the card (unless ``warmup`` is False), then one
    call under the profiler with the attribution ranges on; returns the table:
    "summary", "kernels" (by name), "join" (``join``'s output) and
    "kinds"."""
    from torch.profiler import ProfilerActivity, profile

    cuda = pipe.sd.device.type == "cuda"

    def call(timed: bool):
        if batch:
            seeds = workload.BATCH_SEEDS if timed else [workload.WARMUP_SEED] * len(workload.BATCH_SEEDS)
            return workload.generate_batch(pipe, seeds, steps=steps)
        return [workload.generate(pipe, workload.TIMED_SEED if timed else workload.WARMUP_SEED, steps=steps)]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if warmup and cuda:
        call(timed=False)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with attribution_ranges(pipe.sd) as kinds:
            t0 = time.perf_counter()
            outs = call(timed=True)
            sync()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events, totals = events_from_profiler(prof, cuda)
    joined = join(events, totals, kinds)
    join_s = time.perf_counter() - t0
    del prof, events

    by_family: dict = {}
    kernels = []
    for name, (us, count) in totals.items():
        fam = family(name)
        by_family[fam] = by_family.get(fam, 0.0) + us / 1e3
        kernels.append({"name": name[:160], "family": fam, "ms": us / 1e3, "count": count})
    kernels.sort(key=lambda k: -k["ms"])
    images = len(outs)
    summary = {"model": pipe.sd.config.name, "steps": steps, "images": images, "wall_s": wall}
    if cuda:
        device_ms = sum(by_family.values())
        launches = sum(k["count"] for k in kernels)
        summary.update(
            device_kernel_ms=device_ms,
            device_kernel_ms_per_image=device_ms / images,
            launches=launches,
            launches_per_image=launches / images,
            device_busy_share=device_ms / 1e3 / wall if wall > 0 else None,
        )
    else:  # no device: the CPU ops' own time stands in the join, under its own name
        summary.update(device_kernel_ms=None, device_kernel_ms_per_image=None, launches=None,
                       launches_per_image=None, device_busy_share=None)
    summary["n_evals_total"] = sum(int(o.diagnostics.n_evals.sum()) for o in outs)
    summary["family_ms" if cuda else "cpu_op_family_ms"] = dict(sorted(by_family.items(), key=lambda kv: -kv[1]))
    summary.update(
        join_unit="device kernel ms" if cuda else "cpu op self ms",
        join_closes=joined["closes"],
        join_unattributed_ms=sum(f["unattributed_ms"] for f in joined["families"].values()),
        join_rows=len(joined["rows"]),
        join_s=join_s,
    )
    return {"summary": summary, "kernels": kernels, "join": joined, "kinds": kinds}


# ---------------------------------------------------------------------------
# printing
# ---------------------------------------------------------------------------


def top_keys(joined: dict, fam: str, n: int, by: str = "ms") -> List[dict]:
    """The ``n`` largest (module, op) rows of family ``fam`` by ``by``."""
    rows = [r for r in joined["rows"] if r["family"] == fam]
    return sorted(rows, key=lambda r: -r[by])[:n]


def by_kind(joined: dict, fam: str) -> List[dict]:
    """Family ``fam``'s rows summed by (module kind, op, backward)."""
    acc: Dict[Tuple[str, str, bool], List[float]] = {}
    for r in joined["rows"]:
        if r["family"] == fam:
            a = acc.setdefault((r["kind"], r["op"], r["backward"]), [0.0, 0])
            a[0] += r["ms"]
            a[1] += r["launches"]
    out = [{"kind": k, "op": op, "backward": b, "ms": ms, "launches": n} for (k, op, b), (ms, n) in acc.items()]
    return sorted(out, key=lambda r: -r["ms"])


def _row_text(r: dict, label: str) -> str:
    return f"{r['ms']:10.2f} ms {r['launches']:7d}x  {label}{' (backward)' if r['backward'] else ''}  {r['op'][:60]}"


def report(table: dict, top: int = 5) -> None:
    """Print the summary line, the kernels by name, and the breakdown."""
    print(json.dumps(table["summary"]), flush=True)
    for k in table["kernels"][:25]:
        print(f"{k['ms']:10.2f} ms {k['count']:6d}x {k['family']:18s} {k['name'][:100]}")
    joined = table["join"]
    unit = table["summary"]["join_unit"]
    print(f"\nby module and op ({unit}; join closes: {joined['closes']})")
    for fam, f in joined["families"].items():
        print(f"\n[{fam}] {f['ms']:.2f} ms / {f['launches']} in all; rows {f['rows_ms']:.2f} ms / "
              f"{f['rows_launches']}, unattributed {f['unattributed_ms']:.2f} ms / {f['unattributed_launches']}"
              f"{'' if f['closes'] else '  DOES NOT CLOSE'}")
        for by in ("ms", "launches"):
            print(f"  top {top} by {by}:")
            for r in top_keys(joined, fam, top, by):
                print("  " + _row_text(r, r["module"]))
        if fam in FULL_FAMILIES:
            print("  in full, by module kind:")
            for r in by_kind(joined, fam):
                print("  " + _row_text(r, r["kind"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", action="store_true", help="profile the batch path (B = 4)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model", default="sd15", choices=("sd15", "sd21", "micro"))
    parser.add_argument("--steps", type=int, default=workload.STEPS)
    parser.add_argument("--analyze", metavar="FILE", help="print a saved profile_ops.json again; runs nothing")
    args = parser.parse_args(argv)

    if args.analyze:
        with open(args.analyze) as f:
            report(json.load(f))
        return 0
    cuda = torch.device(args.device).type == "cuda"
    pipe = workload.create(args.device, args.model, torch.bfloat16 if cuda else torch.float32)
    table = run(pipe, batch=args.batch, steps=args.steps)
    os.makedirs(OUT_DIR, exist_ok=True)
    suffix = "_batch" if args.batch else ""
    with open(os.path.join(OUT_DIR, f"profile{suffix}.json"), "w") as f:
        json.dump({"summary": table["summary"], "kernels": table["kernels"]}, f, indent=1)
    with open(os.path.join(OUT_DIR, f"profile_ops{suffix}.json"), "w") as f:
        json.dump(table, f)
    report(table)
    if not table["join"]["closes"]:
        print("profile: the join does not close", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
