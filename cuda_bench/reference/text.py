"""Prompt side of the reference: the hash tokenizer, the meta-prompt's box
and point annotations, and the guidance spec (token slots, box masks,
centers), as plain numpy and tensors."""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

BOS, EOS, CONTEXT = 49406, 49407, 77
COOR, BOX = 0, 1


def encode(text: str) -> List[int]:
    """One id per whitespace word (md5 into [1, 49000]), framed by BOS/EOS."""
    ids = [BOS] + [int(hashlib.md5(w.encode()).hexdigest(), 16) % 49000 + 1 for w in text.strip().lower().split()]
    return (ids + [EOS])[:CONTEXT]


def pad_ids(text: str) -> List[int]:
    ids = encode(text)
    return ids + [EOS] * (CONTEXT - len(ids))


@dataclasses.dataclass
class Annotation:
    subprompt: str
    kind: int
    target: Tuple[float, ...]  # (x, y) or (x, y, w, h), fractions of the image


def parse_prompt(meta_prompt: str) -> Tuple[str, List[Annotation]]:
    """``a [robot:.6,.3,.4,.55] and a [blue vase:0,.3,.4,.55]`` -> ("a robot
    and a blue vase", annotations). Brackets do not nest here; a custom
    loss annotation is not supported."""
    words: List[str] = []
    anns: List[Annotation] = []
    rest = meta_prompt
    while rest.strip():
        rest = rest.lstrip(" ")
        if rest.startswith("["):
            end = rest.index("]")
            token, coords = rest[1:end].split(":", 1)
            token = token.strip(" ")
            nums = tuple(float(v) for v in coords.strip(" ").split(","))
            if token == "CustomLoss" or len(nums) not in (2, 4):
                raise ValueError(f"the reference parses boxes and points only: {rest[:end + 1]!r}")
            anns.append(Annotation(token, COOR if len(nums) == 2 else BOX, nums))
            words.append(token)
            rest = rest[end + 1:]
        else:
            cut = min([i for i in (rest.find(" "), rest.find("[")) if i >= 0] or [len(rest)])
            words.append(rest[:cut])
            rest = rest[cut:]
    return " ".join(w for w in words if w), anns


@dataclasses.dataclass
class Spec:
    token_mask: torch.Tensor  # bool[K]
    ann_type: torch.Tensor  # int64[K], -1 unbound
    center_xy: torch.Tensor  # f32[K, 2]
    subprompt_id: torch.Tensor  # int64[K]
    valid_text: torch.Tensor  # bool[K]
    inside_mask: torch.Tensor  # f32[K, R, R]
    n_groups: int
    res: int


def _find_span(full: Sequence[int], sub: Sequence[int]) -> Optional[List[int]]:
    n = len(sub)
    for i in range(len(full) - n + 1):
        if list(full[i:i + n]) == list(sub):
            return list(range(i, i + n))
    return None


def build_spec(prompt: str, anns: Sequence[Annotation], res: int, shrink_factor: float, normalize_eot: bool,
               device) -> Spec:
    """Bind each annotation's words to their slots of the prompt's ids
    (later annotations overwrite) and lay its box over the R x R grid of
    cell centres, shrunk by ``shrink_factor`` of its size on each side."""
    full = encode(prompt)
    K = CONTEXT
    token_mask = np.zeros(K, bool)
    ann_type = np.full(K, -1, np.int64)
    center = np.zeros((K, 2), np.float32)
    group = np.full(K, -1, np.int64)
    inside = np.zeros((K, res, res), np.float32)
    groups: List[str] = []
    jj, ii = np.meshgrid(np.arange(res), np.arange(res))
    cx, cy = jj + 0.5, ii + 0.5
    for a in anns:
        span = _find_span(full, encode(a.subprompt)[1:-1])
        if span is None:
            continue
        if a.subprompt not in groups:
            groups.append(a.subprompt)
        for idx in span:
            token_mask[idx] = True
            ann_type[idx] = a.kind
            group[idx] = groups.index(a.subprompt)
            if a.kind == COOR:
                center[idx] = a.target
            else:
                x, y, w, h = (v * res for v in a.target)
                center[idx] = ((a.target[0] + a.target[2] / 2), (a.target[1] + a.target[3] / 2))
                ox, oy = shrink_factor * w, shrink_factor * h
                inside[idx] = ((cx >= x + ox) & (cx <= x + w - ox) & (cy >= y + oy) & (cy <= y + h - oy))
    valid = np.zeros(K, bool)
    valid[1:(len(full) - 1) if normalize_eot else (K - 1)] = True

    def t(a):
        return torch.as_tensor(a, device=device)

    return Spec(t(token_mask), t(ann_type), t(center), t(group), t(valid), t(inside), max(len(groups), 1), res)
