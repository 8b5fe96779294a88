"""Reading one profiled batch: each device kernel joined to the module and
op that launched it, the union of kernel time, and the idle gaps.

A frozen copy of the port's profile join (the profiler's raw kineto
events, each kernel to the op that launched it by correlation, the op to
the innermost module range around it, a backward kernel to the forward
module of its autograd node by sequence number), with module ranges only.
Families are named by the join's op, not by substrings of kernel names:
PyTorch's elementwise kernels on strided operands are named ``nocast``,
which a "cast" substring would count as copies.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

MODULE_PREFIX = "module: "
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "
UNATTRIBUTED = "unattributed"


@dataclasses.dataclass
class Event:
    name: str
    parent: Optional[int] = None
    start: float = 0.0  # us
    thread: int = 0
    seq: int = -1
    fwd_thread: int = 0


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # us from the trace's start
    dur: float  # us
    event: Optional[int]  # the CPU op that launched it


class Join:
    """(module path or None, backward) of each CPU event, memoized."""

    def __init__(self, events: Sequence[Event]):
        self.events = events
        self.memo: Dict[int, Tuple[Optional[str], bool]] = {}
        in_bwd: List[Optional[bool]] = [None] * len(events)
        for i in range(len(events)):
            self._in_backward(i, in_bwd)
        self.forward: Dict[Tuple[int, int], List[Tuple[float, int]]] = {}
        for i, e in enumerate(events):
            if e.seq >= 0 and not in_bwd[i]:
                self.forward.setdefault((e.thread, e.seq), []).append((e.start, i))
        for lst in self.forward.values():
            lst.sort()

    def _in_backward(self, i: int, in_bwd: list) -> bool:
        chain, j = [], i
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
        e = self.events[i]
        lst = self.forward.get((e.fwd_thread or e.thread, e.seq), [])
        k = bisect.bisect_left(lst, (e.start, -1)) - 1
        return lst[k][1] if k >= 0 else None

    def context(self, i: Optional[int]) -> Tuple[Optional[str], bool]:
        if i is None:
            return None, False
        if i in self.memo:
            return self.memo[i]
        e = self.events[i]
        if e.name.startswith(MODULE_PREFIX):
            out = (e.name[len(MODULE_PREFIX):], False)
        elif e.name.startswith(BACKWARD_PREFIX) and e.seq >= 0:
            out = (self.context(self.forward_of(i))[0], True)
        else:
            out = self.context(e.parent)
        self.memo[i] = out
        return out

    def key(self, i: Optional[int]) -> Tuple[str, str, bool]:
        """(module path or ``UNATTRIBUTED``, op, backward) of a kernel's op."""
        if i is None:
            return UNATTRIBUTED, "(no launching op)", False
        module, bwd = self.context(i)
        name = self.events[i].name
        return (module or UNATTRIBUTED), ("(module's own code)" if name.startswith(MODULE_PREFIX) else name), bwd


FAMILIES = (
    ("conv", ("convolution",)),
    ("matmul", ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
    ("copy", ("aten::copy_", "aten::cat", "aten::fill_", "aten::zero_", "aten::clone", "aten::_to_copy",
              "aten::index", "aten::index_put_")),
)


def family(op: str, kernel: str) -> str:
    """A kernel's row in the breakdown, by the op that launched it: a
    family of aten ops, or the kernel's own name when no aten op launched
    it (the port's hand-written kernels, launched through the runtime)."""
    for fam, keys in FAMILIES:
        if any(op == k or (not k.startswith("aten::") and k in op) for k in keys):
            return f"{fam}: {op}"
    if not op.startswith("aten::"):
        return f"kernel: {kernel[:80]}"
    return f"elementwise: {op}"


def is_device_work(e) -> bool:
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return "annotation" not in str(kind) and not e.name().startswith(MODULE_PREFIX)


def read(prof) -> Tuple[List[Event], List[Kernel], int]:
    """The profile's CPU events, nested by time on each thread, its
    device kernels (copies and fills included) with their launching op,
    and the number of CUDA-graph launches: a replay runs no module hook,
    so the kernels it runs fall outside every module range."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    raw = results.events()
    kind = type(raw[0]) if raw else object
    hidden = getattr(kind, "is_hidden_event", lambda e: False)
    cpu, device = [], []
    graph_launches = 0
    for e in raw:
        graph_launches += "GraphLaunch" in e.name()
        dt = e.device_type()
        if dt == DeviceType.CPU:
            if e.linked_correlation_id() > 0 or e.is_async() or hidden(e):
                continue
            cpu.append((e.start_thread_id(), e.start_ns() - t0, t0 - e.end_ns(), e.name(), e.sequence_nr(),
                        e.fwd_thread_id(), e.correlation_id()))
        elif dt == DeviceType.CUDA and not hidden(e) and is_device_work(e):
            device.append((e.linked_correlation_id(), e.name(), (e.start_ns() - t0) / 1e3, e.duration_ns() / 1e3))
    del raw
    cpu.sort(key=lambda c: c[:3])
    events: List[Event] = []
    by_corr: Dict[int, int] = {}
    around: List[int] = []
    ends: List[int] = []
    for thread, start, neg_end, name, seq, fwd_thread, corr in cpu:
        while around and (events[around[-1]].thread != thread or ends[around[-1]] <= start):
            around.pop()
        i = len(events)
        events.append(Event(name, around[-1] if around else None, start / 1e3, thread, seq, fwd_thread))
        ends.append(-neg_end)
        around.append(i)
        if corr > 0:
            by_corr[corr] = i
    kernels = [Kernel(name, start, dur, by_corr.get(corr)) for corr, name, start, dur in device]
    kernels.sort(key=lambda k: k.start)
    return events, kernels, graph_launches


def busy_us(kernels: Sequence[Kernel]) -> float:
    """The union of the kernels' intervals (kernels on several streams
    overlap; each instant counts once)."""
    total, end = 0.0, float("-inf")
    for k in sorted(kernels, key=lambda k: k.start):
        s, e = k.start, k.start + k.dur
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events: Sequence[Event], kernels: Sequence[Kernel], top: int = 10) -> Dict:
    """Per (module, op, backward) kernel time; the top device operations by
    family and op; the longest idle gaps named by the op whose kernel
    ended them (what the device waited for the host to issue)."""
    j = Join(events)
    rows: Dict[Tuple[str, str, bool], List[float]] = {}
    keyed = []
    for k in kernels:
        key = j.key(k.event)
        r = rows.setdefault(key, [0.0, 0])
        r[0] += k.dur
        r[1] += 1
        keyed.append((k, key))
    by_op: Dict[str, float] = {}
    for k, (_module, op, _bwd) in keyed:
        name = family(op, k.name)
        by_op[name] = by_op.get(name, 0.0) + k.dur
    gaps: Dict[str, float] = {}
    end = None
    for k, (module, op, bwd) in sorted(keyed, key=lambda kk: kk[0].start):
        if end is not None and k.start > end:
            # a kernel whose op the profiler did not see (launched from another thread) is named by itself
            what = op if k.event is not None else k.name[:60]
            name = f"before {what}{' (backward)' if bwd else ''} in {module.split('.')[0]}"
            gaps[name] = gaps.get(name, 0.0) + (k.start - end)
        end = k.start + k.dur if end is None else max(end, k.start + k.dur)
    return {
        "rows": rows,
        "device_ops": sorted(([n, us / 1e6] for n, us in by_op.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, us / 1e6] for n, us in gaps.items()), key=lambda r: -r[1])[:top],
    }


@contextlib.contextmanager
def module_ranges(modules: Dict[str, object]):
    """For the time of the block, every module of each named root runs
    inside a ``record_function`` range ``MODULE_PREFIX`` + its dotted path."""
    from torch.autograd.profiler import record_function

    handles, open_ranges = [], []

    def enter(_mod, _args, name):
        rf = record_function(name)
        rf.__enter__()
        open_ranges.append(rf)

    def leave(_mod, _args, _out):
        open_ranges.pop().__exit__(None, None, None)

    for root, module in modules.items():
        for path, mod in module.named_modules(prefix=root):
            handles.append(mod.register_forward_pre_hook(functools.partial(enter, name=MODULE_PREFIX + path)))
            handles.append(mod.register_forward_hook(leave, always_call=True))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
