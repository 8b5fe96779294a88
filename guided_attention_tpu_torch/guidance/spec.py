"""GuidanceSpec: the precomputed description of a guided run, as tensors.

Every annotation target (crosshair points, boxes), token binding, box weight
map and paint-with-words mask is built host-side with numpy into arrays
indexed by token slot [0..76], then placed on the run's device once.
Counterpart of the JAX package's ``guidance/spec.py``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from guided_attention_tpu_torch.annotation import Annotation, AnnotationType, Rect
from guided_attention_tpu_torch.config import HyperParams

ANN_NONE = -1
MAX_TOKENS = 77  # CLIP context length


@dataclasses.dataclass
class GuidanceSpec:
    """Fixed-shape tensors describing all annotations for one prompt.

    K = text context length (77). R = attention_res (default 16).
    """

    token_mask: torch.Tensor  # bool[K]  — tokens bound to an annotation
    ann_type: torch.Tensor  # int64[K] — AnnotationType or ANN_NONE
    center_xy: torch.Tensor  # f32[K,2] — centering target (COOR xy / BOX center)
    subprompt_id: torch.Tensor  # int64[K] — group id, -1 if unbound
    valid_text: torch.Tensor  # bool[K]  — tokens kept by the re-softmax slice
    inside_mask: torch.Tensor  # f32[K,R,R] — 1 inside the (shrunk) box
    w_in: torch.Tensor  # f32[K,R,R] — normalized strict inside weights
    w_out: torch.Tensor  # f32[K,R,R] — normalized strict outside weights
    at_most: torch.Tensor  # f32[K]   — 1/num_inside per BOX token
    # paint-with-words: res -> f32[res*res, K] additive score mask
    pww_masks: Dict[int, torch.Tensor]
    n_groups: int = 1
    custom_group: int = -1
    attention_res: int = 16
    # tuple of (name, loss object, args); loss.calc_loss(maps, spec, args)
    custom_losses: Tuple[Any, ...] = ()
    # host-side metadata (token slot -> word) for logging/visualization
    words: Tuple[Tuple[int, str], ...] = ()
    # subprompt strings in group-id order (custom group excluded)
    subprompts: Tuple[str, ...] = ()


def _inside_box_grid(rect: Rect, res: int, shrink_factor: float) -> np.ndarray:
    """Boolean [res,res] grid of cells inside the shrunk box, cell centres
    sampled at +0.5 (reference utils/helpers.py:164-173)."""
    r = rect.of_size(res)
    jj, ii = np.meshgrid(np.arange(res), np.arange(res))  # jj = x/col, ii = y/row
    cx = jj + 0.5
    cy = ii + 0.5
    ox = shrink_factor * r.width
    oy = shrink_factor * r.height
    return (
        (cx >= r.x + ox)
        & (cx <= r.x + r.width - ox)
        & (cy >= r.y + oy)
        & (cy <= r.y + r.height - oy)
    )


def _box_weight_maps(
    rect: Rect, res: int, shrink_factor: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(inside_mask, w_in, w_out, at_most) of one box (reference
    utils/helpers.py:215-246), weights normalized within their region.
    Degenerate zero-size boxes clamp their distance denominators instead of
    dividing by zero."""
    r = rect.of_size(res)
    inside = _inside_box_grid(rect, res, shrink_factor)
    jj, ii = np.meshgrid(np.arange(res), np.arange(res))
    cx = jj + 0.5
    cy = ii + 0.5
    rcx, rcy = r.center()
    c_dist = np.sqrt(
        (2.0 * (rcx - cx) / max(r.width, 1e-6)) ** 2
        + (2.0 * (rcy - cy) / max(r.height, 1e-6)) ** 2
    ) / np.sqrt(2.0)
    w_inside = np.interp(c_dist, [0.0, 0.333, 0.666, 1.0], [3.0, 2.5, 1.0, 0.2])
    weights = np.where(inside, w_inside, 1.0)
    num_inside = int(inside.sum())
    sum_inside = weights[inside].sum() if num_inside else 1.0
    sum_outside = weights[~inside].sum() if num_inside < res * res else 1.0
    w_in = np.where(inside, weights / sum_inside, 0.0)
    w_out = np.where(~inside, weights / sum_outside, 0.0)
    at_most = 1.0 / num_inside if num_inside else 0.0
    return inside.astype(np.float32), w_in.astype(np.float32), w_out.astype(np.float32), at_most


def find_token_span(full_ids: Sequence[int], sub_ids: Sequence[int]) -> Optional[List[int]]:
    """First index span of ``sub_ids`` inside ``full_ids`` (reference run.py:69-73)."""
    n = len(sub_ids)
    for i in range(0, len(full_ids) - n + 1):
        if list(full_ids[i : i + n]) == list(sub_ids):
            return list(range(i, i + n))
    return None


def build_guidance_spec(
    tokenizer,
    prompt: str,
    meta_info: Sequence[Annotation],
    hp: HyperParams,
    custom_losses: Optional[Dict[str, Tuple[Any, str]]] = None,
    attention_res: int = 16,
    normalize_eot: bool = False,
    pww_resolutions: Sequence[int] = (8, 16, 32, 64),
    max_tokens: int = MAX_TOKENS,
    device: Any = "cuda",
) -> GuidanceSpec:
    """Bind annotations to token slots and precompute all loss geometry.

    Each annotation's sub-prompt is tokenized without BOS/EOS and matched
    against the full tokenized prompt; every matched slot inherits the
    annotation (later annotations overwrite), as the reference's
    parseMetaPrompt does (run.py:81-91).
    """
    custom_losses = custom_losses or {}
    full_ids = list(tokenizer.encode(prompt))
    K = max_tokens
    R = attention_res

    token_mask = np.zeros(K, dtype=bool)
    ann_type = np.full(K, ANN_NONE, dtype=np.int64)
    center_xy = np.zeros((K, 2), dtype=np.float32)
    subprompt_id = np.full(K, -1, dtype=np.int64)
    inside_mask = np.zeros((K, R, R), dtype=np.float32)
    w_in = np.zeros((K, R, R), dtype=np.float32)
    w_out = np.zeros((K, R, R), dtype=np.float32)
    at_most = np.zeros(K, dtype=np.float32)

    groups: List[str] = []
    words: List[Tuple[int, str]] = []

    for ann in meta_info:
        sub_ids = tokenizer.encode(ann.subprompt)[1:-1]
        span = find_token_span(full_ids, sub_ids)
        if span is None:
            continue
        if ann.subprompt not in groups:
            groups.append(ann.subprompt)
        gid = groups.index(ann.subprompt)
        for idx in span:
            if idx >= K:
                continue
            token_mask[idx] = True
            ann_type[idx] = int(ann.kind)
            subprompt_id[idx] = gid
            words.append((idx, tokenizer.decode([full_ids[idx]])))
            if ann.kind == AnnotationType.COOR:
                center_xy[idx] = np.asarray(ann.target, dtype=np.float32)
            elif ann.kind == AnnotationType.BOX:
                rect: Rect = ann.target
                center_xy[idx] = np.asarray(rect.center(), dtype=np.float32)
                m, wi, wo, am = _box_weight_maps(rect, R, hp.shrink_factor)
                inside_mask[idx] = m
                w_in[idx] = wi
                w_out[idx] = wo
                at_most[idx] = am

    # valid-token mask for the x100 re-softmax (reference pipeline:209-219):
    # SD1.x keeps slots [1:-1] of 77; SD2.1 keeps [1:eot_idx]
    valid_text = np.zeros(K, dtype=bool)
    last_idx = (len(full_ids) - 1) if normalize_eot else (K - 1)
    valid_text[1:last_idx] = True

    # paint-with-words additive masks (reference ptp_utils.py:113-132)
    pww_masks: Dict[int, np.ndarray] = {}
    if hp.paint_with_words_stop > 0:
        for res in pww_resolutions:
            pww_masks[res] = np.zeros((res * res, K), dtype=np.float32)
        for ann in meta_info:
            if ann.kind != AnnotationType.BOX:
                continue
            sub_ids = tokenizer.encode(ann.subprompt)[1:-1]
            span = find_token_span(full_ids, sub_ids)
            if span is None:
                continue
            for res in pww_resolutions:
                grid = _inside_box_grid(ann.target, res, hp.shrink_factor)
                flat = grid.reshape(-1).astype(np.float32) * hp.paint_with_words_weight
                for idx in span:
                    if idx < K:
                        pww_masks[res][:, idx] = flat

    # bind a per-spec COPY: bind() mutates the loss object, and the registry
    # instance is shared across prompts
    custom_items = []
    for name, (obj, args) in custom_losses.items():
        bound = copy.deepcopy(obj)
        bound.bind(tokenizer, prompt, args)
        custom_items.append((name, bound, args))
    n_groups = len(groups) + (1 if custom_items else 0)
    custom_group = len(groups) if custom_items else -1

    def t(a):
        return torch.as_tensor(a, device=device)

    return GuidanceSpec(
        token_mask=t(token_mask),
        ann_type=t(ann_type),
        center_xy=t(center_xy),
        subprompt_id=t(subprompt_id),
        valid_text=t(valid_text),
        inside_mask=t(inside_mask),
        w_in=t(w_in),
        w_out=t(w_out),
        at_most=t(at_most),
        pww_masks={k: t(v) for k, v in pww_masks.items()},
        n_groups=max(n_groups, 1),
        custom_group=custom_group,
        attention_res=R,
        custom_losses=tuple(custom_items),
        words=tuple(words),
        subprompts=tuple(groups),
    )


_SPEC_TENSORS = ("token_mask", "ann_type", "center_xy", "subprompt_id", "valid_text", "inside_mask", "w_in", "w_out",
                 "at_most")


def stack_specs(specs: Sequence[GuidanceSpec]) -> GuidanceSpec:
    """Stack per-prompt specs along a new leading batch axis (the JAX
    package's ``runner._stack_specs``): every tensor, ``pww_masks`` included
    ([B, res*res, K]), gains it; the scalar fields and the custom losses are
    shared, so every prompt must give the same group structure and the same
    custom-loss bindings. ``spec_row`` takes one sample back out."""
    s0 = specs[0]
    for k, s in enumerate(specs[1:], 1):
        if s.n_groups != s0.n_groups or s.custom_group != s0.custom_group:
            raise ValueError(
                "multi-prompt batch requires every prompt to produce the same "
                "sub-prompt group structure (prompt 0: "
                f"{s0.n_groups} groups, custom-loss group {s0.custom_group}; "
                f"prompt {k}: {s.n_groups} groups, custom-loss group "
                f"{s.custom_group}; -1 = no custom loss)"
            )
        if s.custom_losses != s0.custom_losses:
            raise ValueError(
                "multi-prompt batch requires identical custom-loss bindings "
                "across prompts (custom losses bake token indices into the "
                "traced program as static state)"
            )
    stacked = {name: torch.stack([getattr(s, name) for s in specs]) for name in _SPEC_TENSORS}
    pww = {res: torch.stack([s.pww_masks[res] for s in specs]) for res in s0.pww_masks}
    return dataclasses.replace(s0, pww_masks=pww, **stacked)


def spec_row(spec: GuidanceSpec, b) -> GuidanceSpec:
    """Sample ``b`` of a stacked spec, or its rows ``b`` for a slice (views
    of its tensors)."""
    rows = {name: getattr(spec, name)[b] for name in _SPEC_TENSORS}
    return dataclasses.replace(spec, pww_masks={res: m[b] for res, m in spec.pww_masks.items()}, **rows)
