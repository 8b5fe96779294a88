"""Mid-run generation state: persist every N steps, resume exactly.

Counterpart of the JAX package's ``runtime/checkpoint.py``, with the same
file names (``genstate_<identity>_<step:04d>.msgpack``), the same keys
(``identity``, ``step``, ``seg_start``, ``latents``, ``diags`` by
``StepDiag`` field name) and flax's msgpack format, through the port's own
codec (``runtime/serialization``). One file per segment boundary, written
atomically (a per-process tmp file, then ``os.replace``), holds the step
reached, the latents entering it in the dtype that enters the step
(bfloat16 for bf16 runs), and the diagnostics of that segment only, so the
state on disk grows linearly with the run; ``latest_state`` stitches the
chain back together.

The port draws its noise in call order from one ``torch.Generator`` per
sample (``runner.py``), where the JAX package keys every draw by the
absolute step. So the port's carry across a boundary is the latents plus
each sample's generator state, stored under ``generators`` (one uint8
array per sample, by its index); a state file the JAX package wrote has
none.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from guided_attention_tpu_torch.pipeline import StepDiag
from guided_attention_tpu_torch.runtime import serialization

_PREFIX = "genstate_"


def run_identity(*parts: str) -> str:
    """Stable identity of one resumable run (options, seeds, model, ...)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _path(state_dir: str, identity: str, step: int) -> Path:
    return Path(state_dir) / f"{_PREFIX}{identity}_{step:04d}.msgpack"


def save_state(
    state_dir: str,
    identity: str,
    step: int,
    latents: Any,
    diags: StepDiag,
    seg_start: int = 0,
    generators: Optional[Sequence[Any]] = None,
) -> Path:
    """Persist progress through step ``step`` (exclusive): the latents
    entering ``step`` (a torch tensor or numpy array), the diagnostics of
    steps [``seg_start``, ``step``) only, and each sample's generator state.
    Atomic: a crash mid-write never corrupts an existing state file."""
    d = Path(state_dir)
    d.mkdir(parents=True, exist_ok=True)
    payload = {
        "identity": identity,
        "step": int(step),
        "seg_start": int(seg_start),
        "latents": latents,
        "diags": {f.name: getattr(diags, f.name) for f in dataclasses.fields(diags)},
    }
    if generators is not None:
        payload["generators"] = {str(b): g for b, g in enumerate(generators)}
    dst = _path(state_dir, identity, step)
    # per-process tmp name: concurrent writers of one shared state dir never
    # write into each other's file; os.replace is atomic
    tmp = dst.with_suffix(f".tmp{os.getpid()}")
    tmp.write_bytes(serialization.dumps(payload))
    os.replace(tmp, dst)
    return dst


def _run_files(state_dir: str, identity: str) -> List[Path]:
    d = Path(state_dir)
    if not d.is_dir():
        return []

    def step_of(p: Path) -> int:
        # numeric, not lexicographic: runs past 9999 steps keep step order
        suffix = p.stem.rsplit("_", 1)[-1]
        return int(suffix) if suffix.isdigit() else -1

    return sorted(d.glob(f"{_PREFIX}{identity}_*.msgpack"), key=step_of)


def latest_state(
    state_dir: str, identity: str
) -> Optional[Tuple[int, Any, StepDiag, Optional[List[np.ndarray]]]]:
    """Newest resumable state of this run: walks the per-segment files in
    step order and stitches the longest contiguous chain (each file's
    ``seg_start`` equals the previous file's ``step``; a file with
    ``seg_start`` 0 starts a new chain). Returns (step reached, latents
    entering it, diagnostics of [0, step), the last file's generator states
    or None) or None. A torn, foreign or mismatched file is skipped, never
    raised: it cannot block a resume from an older boundary."""
    chain_step, chain_lat, chain_gens, chain_diags = 0, None, None, []
    for f in _run_files(state_dir, identity):
        try:
            payload = serialization.load(f)
            if payload.get("identity") != identity:
                continue
            seg_start = int(payload.get("seg_start", 0))
            step = int(payload["step"])
            diags = StepDiag(**payload["diags"])
            lat = payload["latents"]
            gens = payload.get("generators")
            gens = None if gens is None else [np.asarray(gens[str(b)]) for b in range(len(gens))]
        except Exception:
            continue
        if seg_start == 0:
            chain_step, chain_lat, chain_gens, chain_diags = step, lat, gens, [diags]
        elif seg_start == chain_step:
            chain_step, chain_lat, chain_gens = step, lat, gens
            chain_diags.append(diags)
        # else: an orphaned segment of another grid
    if chain_lat is None:
        return None
    return chain_step, chain_lat, concat_diags(chain_diags), chain_gens


def clear_state(state_dir: str, identity: str) -> None:
    """Remove a completed run's state files."""
    for f in _run_files(state_dir, identity):
        f.unlink(missing_ok=True)


def concat_diags(segments: List[StepDiag]) -> StepDiag:
    """Per-segment diagnostics [B, S_seg, ...] concatenated field by field
    along the step axis. Both resumable entries run the batch loop, so the
    step axis is always 1 (one image is a batch of one)."""
    if len(segments) == 1:
        return segments[0]
    return StepDiag(**{f.name: np.concatenate([np.asarray(getattr(s, f.name)) for s in segments], axis=1)
                       for f in dataclasses.fields(StepDiag)})


def segment_bounds(start: int, total: int, every: int) -> List[Tuple[int, int]]:
    """Segments of [start, total) cut at multiples of ``every``: the cuts
    stay on one grid, so a resumed run writes the same boundaries as the
    run it resumes."""
    if every <= 0:
        raise ValueError("checkpoint_every must be >= 1")
    cuts = sorted({start, total} | {b for b in range(0, total, every) if start < b < total})
    return list(zip(cuts[:-1], cuts[1:]))
