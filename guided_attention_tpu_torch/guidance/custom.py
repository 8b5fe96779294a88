"""Custom-loss plugin API (reference run.py:148-232).

``calc_loss(maps, spec, args)`` receives the x100-re-softmaxed
cross-attention maps as f32[R,R,77] in original token coordinates (invalid
slots zeroed) and returns a scalar tensor; it runs inside the autograd graph
of the guidance eval. Tokenizer-dependent work (token index lookup) happens
once, host-side, in ``bind``.
"""
from __future__ import annotations

import abc
import ast
from typing import Dict, List, Optional, Sequence

import torch

from guided_attention_tpu_torch.guidance.spec import find_token_span


class CustomLossBase(abc.ABC):
    """Base class for user-registered guidance losses (reference run.py:148-173)."""

    @abc.abstractmethod
    def calc_loss(self, cross_attention_maps, spec, text_args: str):
        """Return a scalar loss tensor built from differentiable torch ops."""

    def subprompts_of_interest(self, text_args: str) -> List[str]:
        """Sub-prompts whose maps should be tracked (KEYWORD annotations)."""
        return []

    def bind(self, tokenizer, prompt: str, text_args: str) -> None:
        """Host-side hook: resolve token indices etc. before the run."""

    def static_state(self) -> tuple:
        """Everything bind() resolved; two bound losses are equal iff it is."""
        return ()

    def __eq__(self, other):
        return type(self) is type(other) and self.static_state() == other.static_state()

    def __hash__(self):
        return hash((type(self).__name__, self.static_state()))

    def parse_text_args(self, text_args: str):
        return ast.literal_eval(text_args)

    def find_indices_for_sub_prompt(self, tokenizer, prompt: str, sub_prompt: str):
        full = tokenizer.encode(prompt)[1:-1]
        sub = tokenizer.encode(sub_prompt)[1:-1]
        span = find_token_span(full, sub)
        if span is None:
            return None
        return [i + 1 for i in span]  # original coords (BOS at 0)

    def get_map_for_token(self, maps, token_index: int, pixel_wise_normalization: bool = True):
        m = maps[:, :, token_index]
        if pixel_wise_normalization:
            s = m.sum()
            ok = s > 1e-12
            m = torch.where(ok, m / torch.where(ok, s, torch.ones_like(s)), 0.0)
        return m


class ToLeftOf(CustomLossBase):
    """'[CustomLoss:toLeftOf (cat,vase)]' — keep subprompt A left of B.

    loss = 9 * max(0, (cx_left + 0.2*W - cx_right) / W) over the
    attention-weighted x-centres of the two sub-prompts (reference
    run.py:177-225, with the right centroid divided by its own token count).
    """

    def __init__(self):
        self._left: Optional[Sequence[int]] = None
        self._right: Optional[Sequence[int]] = None

    def _quote_items_in_tuple(self, text_args: str) -> str:
        items = text_args.strip("()").split(",")
        return "(" + ",".join(f"'{i.strip()}'" for i in items) + ")"

    def subprompts_of_interest(self, text_args: str) -> List[str]:
        return list(self.parse_text_args(self._quote_items_in_tuple(text_args)))

    def bind(self, tokenizer, prompt: str, text_args: str) -> None:
        left_sub, right_sub = self.subprompts_of_interest(text_args)
        self._left = tuple(self.find_indices_for_sub_prompt(tokenizer, prompt, left_sub) or ())
        self._right = tuple(self.find_indices_for_sub_prompt(tokenizer, prompt, right_sub) or ())

    def static_state(self) -> tuple:
        return (self._left, self._right)

    def calc_loss(self, maps, spec, text_args: str):
        if not self._left or not self._right:
            return torch.zeros((), dtype=torch.float32, device=maps.device)
        R = maps.shape[1]
        grid = torch.arange(R, dtype=torch.float32, device=maps.device) + 0.5

        def x_center(indices):
            c = torch.zeros((), dtype=torch.float32, device=maps.device)
            for i in indices:
                m = self.get_map_for_token(maps, i, True)
                c = c + torch.einsum("hw,w->", m, grid) / len(indices)
            return c

        gap = 0.2 * R
        loss = (x_center(self._left) + gap - x_center(self._right)) / R
        return torch.clamp(loss * 9.0, min=0.0)


class CustomLossRegistry:
    """Name -> loss object registry (reference run.py:229-232)."""

    def __init__(self):
        self._losses: Dict[str, CustomLossBase] = {}

    def register(self, name: str, loss: CustomLossBase) -> None:
        self._losses[name] = loss

    def __contains__(self, name: str) -> bool:
        return name in self._losses

    def __getitem__(self, name: str) -> CustomLossBase:
        return self._losses[name]

    def as_dict(self) -> Dict[str, CustomLossBase]:
        return dict(self._losses)


def default_registry() -> CustomLossRegistry:
    reg = CustomLossRegistry()
    reg.register("toLeftOf", ToLeftOf())
    return reg
