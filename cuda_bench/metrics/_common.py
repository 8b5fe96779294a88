"""Arithmetic the readers share."""
from __future__ import annotations

from typing import Dict, List, Optional

from cuda_bench import flops


def rows_of(run: Dict, served_only: bool = False) -> List:
    """The outputs of the window's rows (the engine's padding left out
    when ``served_only``)."""
    r = run["result"]
    batches = r.get("batches") or []
    if served_only and "served_rows" in r:
        return [batches[bi].outputs[row] for bi, row in r["served_rows"]]
    return [o for b in batches for o in (b.outputs or ())]


def unet_flops(run: Dict, outputs) -> float:
    u = run["config"]["arch"]["unet"]
    res = run["config"]["arch"]["attention_res"]
    return sum(flops.image_flops(u, o.diagnostics.n_evals, o.diagnostics.recursions, res) for o in outputs)


def profiled(run: Dict) -> Optional[Dict]:
    t = run.get("traced")
    return t if t and t.get("kernels") else None


def attention_time_us(run: Dict) -> float:
    """Device time of the kernels launched inside the UNet's attn1 / attn2
    modules (their projections included), forward and backward."""
    us = 0.0
    for (module, _op, _bwd), (dur, _count) in profiled(run)["summary"]["rows"].items():
        parts = module.split(".")
        if parts[0] == "unet" and ("attn1" in parts or "attn2" in parts):
            us += dur
    return us


def percent(x: float) -> float:
    return float(100.0 * x)

