"""What the drivers share: the layouts drawn from the seed, and the knobs
every request carries."""
from __future__ import annotations

from typing import Dict

import numpy as np


def layout(rng: np.random.Generator, mix: Dict) -> str:
    """A meta-prompt binding the mix's objects to boxes of the mix's fixed
    sizes, placed by ``rng``: every seed gives the same work at other
    places."""
    words = []
    for obj in mix["objects"]:
        w, h = obj["size"]
        x = round(float(rng.uniform(0.0, 1.0 - w)), 2)
        y = round(float(rng.uniform(0.0, 1.0 - h)), 2)
        words.append(f"a [{obj['word']}:{x:g},{y:g},{w:g},{h:g}]")
    return " and ".join(words)


def knobs(mix: Dict, sd_2_1: bool) -> Dict:
    """The generation's keywords: the mix's, decoded, no diagnostics."""
    out = dict(mix.get("knobs", {}))
    if "thresholds" in out:
        out["thresholds"] = {int(k): float(v) for k, v in out["thresholds"].items()}
    out.update(sd_2_1=sd_2_1, capture_diagnostics=False)
    return out


def seed_block(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 2**31 - 1024))

