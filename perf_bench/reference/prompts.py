"""PREGO's step prompt, written out again from the inputs (llama_meta.py's
format with the default context style and numeric symbols), and the byte
tokenizer's ids for it: UTF-8 bytes after bos (256); eos is 257."""

from __future__ import annotations

from typing import List, Sequence

BOS, EOS = 256, 257


def step_prompt(context: str, toy: str, seq: Sequence[int], i: int) -> str:
    """The prompt that anticipates step i of ``seq`` from the steps before it."""
    hist = ", ".join(["-1"] + [str(s) for s in seq[:i]])
    return f"{context}Sequence type: {toy}\nInput Sequence:\n {hist}\nNext Symbol:\n"


def ids(text: str) -> List[int]:
    return [BOS] + list(text.encode("utf-8"))
