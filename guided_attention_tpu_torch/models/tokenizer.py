"""Tokenizer loading.

``load_tokenizer(None)`` gives ``SimpleTokenizer``: a deterministic word-level
tokenizer with CLIP's framing (BOS=49406, EOS=49407, context 77, EOS padding),
so that token binding, guidance specs and tests run without any download.
``load_tokenizer(path)`` loads transformers' CLIPTokenizer from a local
checkpoint directory and raises if that fails: a caller who names a
checkpoint never silently gets the hash tokenizer instead.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

BOS = 49406
EOS = 49407
CONTEXT = 77


class SimpleTokenizer:
    """Deterministic whitespace tokenizer with CLIP-style framing.

    Word -> id via a stable hash into [1, 49000]; one token per word.
    """

    model_max_length = CONTEXT

    def encode(self, text: str) -> List[int]:
        words = [w for w in text.strip().lower().split() if w]
        ids = [BOS]
        for w in words:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16) % 49000
            ids.append(h + 1)  # avoid 0
        ids.append(EOS)
        return ids[:CONTEXT]

    def __call__(self, text: str, padding: Optional[str] = None, **kw):
        ids = self.encode(text)
        if padding == "max_length" or kw.get("max_length"):
            ids = ids + [EOS] * (CONTEXT - len(ids))
        return {"input_ids": ids}

    def pad_to_context(self, ids: List[int]) -> List[int]:
        return (ids + [EOS] * CONTEXT)[:CONTEXT]

    def decode(self, ids) -> str:
        if isinstance(ids, int):
            ids = [ids]
        out = []
        for i in ids:
            if i == BOS:
                out.append("<|startoftext|>")
            elif i == EOS:
                out.append("<|endoftext|>")
            else:
                out.append(f"tok{int(i)}")
        return " ".join(out)


def load_tokenizer(model_path: Optional[str] = None):
    """SimpleTokenizer without a path; CLIPTokenizer from ``model_path``
    (its ``tokenizer/`` subfolder, else the directory itself) with one."""
    if model_path is None:
        return SimpleTokenizer()
    from transformers import CLIPTokenizer

    errors = []
    for kw in ({"subfolder": "tokenizer"}, {}):
        try:
            return CLIPTokenizer.from_pretrained(model_path, **kw)
        # transformers reports a missing or broken tokenizer as OSError,
        # ValueError or TypeError depending on what is missing; every one
        # of them is reported below, none is swallowed
        except Exception as e:  # noqa: BLE001
            errors.append(f"{kw or 'root'}: {type(e).__name__}: {e}")
    raise RuntimeError(f"no CLIP tokenizer under {model_path!r}: " + "; ".join(errors))


def pad_ids(tokenizer, text: str, length: int = CONTEXT) -> List[int]:
    """Tokenize + EOS-pad to fixed context length."""
    ids = list(tokenizer.encode(text))[:length]
    pad_id = EOS
    if getattr(tokenizer, "pad_token_id", None) is not None:
        pad_id = tokenizer.pad_token_id
    return ids + [pad_id] * (length - len(ids))
