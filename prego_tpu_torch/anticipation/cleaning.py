"""LLM output cleaning into prediction symbols.

Parity surface: llama_meta.py:176-211 ("meta" mode) and llm_hf.py:186-212
("hf" mode). Noted quirk kept as spec: in llama_meta the first whitespace/
punctuation regex is dead code — its result is immediately overwritten by
``res["generation"].strip("_")`` (llama_meta.py:182-184) — so "meta" mode
only strips underscores before the per-type handling.

Per type_prompt:
  num   — strip non-numeric chars from both ends, int() if possible
          (non-parsable stays a string and simply never matches an int gt);
  emoji — keep the FIRST character of the cleaned string (llama_meta.py:200-204;
          note multi-codepoint emoji lose their modifiers here — load-bearing
          for matching, since gt symbols compare against this first char);
  alpha — keep text up to the first newline.
"""

from __future__ import annotations

import re
from typing import Union

Symbol = Union[int, str]


def clean_generation(text: str, type_prompt: str, mode: str = "meta") -> Symbol:
    if mode == "meta":
        v = text.strip("_")
    elif mode == "hf":
        v = re.sub(r"[ \n\.,;:]+", "", text)
        v = v.strip("_")
    else:
        raise ValueError(f"unknown cleaning mode {mode!r}")

    if type_prompt == "num":
        v = re.sub(r"^[^0-9]*|[^0-9]*$", "", v)
        try:
            return int(v)
        except ValueError:
            return v
    if type_prompt == "emoji":
        return v[0] if v else ""
    # alpha: cut at first newline; str.find returns -1 when absent, which
    # drops the last char — reference behavior (llama_meta.py:207)
    return v[: v.find("\n")]
