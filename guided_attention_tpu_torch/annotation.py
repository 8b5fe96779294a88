"""The meta-prompt annotation language.

Grammar (parity with reference utils/helpers.py:41-114):

    ``a [robot:.6,.3,.4,.55] and a [blue vase:0,.3,.4,.55]``

  * ``[token:x,y]``       -> COOR crosshair annotation (fractions of the image)
  * ``[token:x,y,w,h]``   -> BOX bounding-box annotation (fractions)
  * ``[CustomLoss:name args]`` -> plugin loss; the bracketed text is elided
    from the prompt; the registered loss's ``subprompts_of_interest`` are
    added as KEYWORD annotations.
  * everything else passes through into the clean prompt.

``token`` may contain spaces ("blue vase"); brackets may nest (the matcher
counts depth, reference utils/helpers.py:41-56).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple


class AnnotationType(enum.IntEnum):
    """Annotation kinds (reference utils/helpers.py:10-13)."""

    COOR = 0
    BOX = 1
    KEYWORD = 2


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned rectangle in units of ``size`` (reference utils/helpers.py:15-30)."""

    x: float
    y: float
    width: float
    height: float
    size: float = 1.0

    @property
    def right(self) -> float:
        return self.x + self.width

    @property
    def bottom(self) -> float:
        return self.y + self.height

    def center(self) -> Tuple[float, float]:
        return (self.x + self.width / 2.0, self.y + self.height / 2.0)

    def of_size(self, new_size: float) -> "Rect":
        r = float(new_size) / self.size
        return Rect(self.x * r, self.y * r, self.width * r, self.height * r, new_size)


@dataclasses.dataclass(frozen=True)
class Annotation:
    """One parsed annotation: the sub-prompt it binds to and its target."""

    subprompt: str
    kind: AnnotationType
    target: Any  # (x, y) for COOR, Rect for BOX, None for KEYWORD

    # Tuple view matching the reference's ``meta_info`` entries
    # (utils/helpers.py:92-102): (token, AnnotationType, payload).
    def as_tuple(self):
        return (self.subprompt, self.kind, self.target)


def find_matching_bracket(s: str) -> int:
    """Index of the ']' matching the '[' at s[0] (reference utils/helpers.py:41-56).

    ``s[0]`` is assumed to be the opening bracket; nested brackets are skipped.
    Returns -1 if unbalanced.
    """
    depth = 0
    for i in range(1, len(s)):
        c = s[i]
        if c == "[":
            depth += 1
        elif c == "]":
            if depth == 0:
                return i
            depth -= 1
    return -1


def _add_word(prompt: str, token: str) -> str:
    if len(prompt) == 0 or prompt[-1] == " ":
        return prompt + token
    return prompt + " " + token


def parse_prompt(
    meta_prompt: str,
    registered_losses: Optional[Dict[str, Any]] = None,
) -> Tuple[str, List[Annotation], Dict[str, Tuple[Any, str]]]:
    """Parse a meta-prompt into (clean prompt, annotations, custom losses).

    Mirrors reference utils/helpers.py:59-114 exactly, except the CustomLoss
    argument string is delimited by the annotation's own closing bracket
    (the reference assumed the CustomLoss annotation was the final text and
    sliced to end-of-string, helpers.py:85-88; both agree whenever the
    annotation is last).

    ``registered_losses`` maps name -> loss object implementing the
    CustomLoss protocol (see guidance/custom.py). Unknown names raise KeyError
    as in the reference (helpers.py:89).
    """
    registered_losses = registered_losses or {}
    prompt = ""
    meta_info: List[Annotation] = []
    custom_losses: Dict[str, Tuple[Any, str]] = {}
    rest = meta_prompt
    while True:
        rest = rest.lstrip(" ")
        space_index = rest.index(" ") if " " in rest else -1
        meta_index = rest.index("[") if "[" in rest else -1
        if space_index == -1 and meta_index == -1:
            # Deviation from reference helpers.py:72-73, which returns here
            # without adding ``rest`` — silently dropping a single trailing
            # word after the final annotation ("a [rat:.1,.2] runs" -> "a
            # rat"). We keep the word.
            if rest:
                prompt = _add_word(prompt, rest)
            return prompt, meta_info, custom_losses
        if meta_index == -1:
            return _add_word(prompt, rest), meta_info, custom_losses
        if space_index == -1 or meta_index < space_index:
            match = find_matching_bracket(rest[meta_index:])
            if match == -1:
                # Deviation from reference helpers.py:41-56/59-: an unbalanced
                # '[' there yields end index -1, the slice rest[0:] never
                # shrinks, and the parse loops FOREVER (hanging the caller —
                # for a server, behind the pipeline lock). Reject instead.
                raise ValueError(
                    f"unbalanced '[' in meta-prompt: {rest[meta_index:][:40]!r}"
                )
            end_meta_index = match + meta_index
            colon_index = rest.index(":")
            token = rest[meta_index + 1 : colon_index].strip(" ")
            coors = rest[colon_index + 1 : end_meta_index].strip(" ")
            numbers = coors.split(",")
            skip_word = False
            if token == "CustomLoss":  # plugin loss (helpers.py:83-92)
                skip_word = True
                name_and_args = rest[colon_index + 1 : end_meta_index]
                name_sep = name_and_args.index(" ")
                name = name_and_args[:name_sep]
                args = name_and_args[name_sep + 1 :]
                loss_obj = registered_losses[name]
                custom_losses[name] = (loss_obj, args)
                for sub in loss_obj.subprompts_of_interest(args):
                    meta_info.append(Annotation(sub, AnnotationType.KEYWORD, None))
            elif len(numbers) == 2:
                x, y = float(numbers[0]), float(numbers[1])
                meta_info.append(Annotation(token, AnnotationType.COOR, (x, y)))
            elif len(numbers) == 4:
                x, y = float(numbers[0]), float(numbers[1])
                w, h = float(numbers[2]), float(numbers[3])
                meta_info.append(Annotation(token, AnnotationType.BOX, Rect(x, y, w, h, 1.0)))
            else:
                pass  # malformed annotation: silently skipped, as in reference
            if not skip_word:
                prompt = _add_word(prompt, token)
            rest = rest[end_meta_index + 1 :]
        else:  # plain word
            token = rest[0 : space_index + 1]
            prompt = _add_word(prompt, token)
            rest = rest[space_index:]


def meta_prompt_clean(meta_prompt: str, interactive: bool = False) -> str:
    """Filesystem-safe name for a meta-prompt (reference utils/helpers.py:119-123)."""
    clean = (
        meta_prompt.replace("[", "_").replace("]", "_").replace(":", "_").replace(".", "_")
    )
    if interactive:
        return clean[0:5]
    return clean
