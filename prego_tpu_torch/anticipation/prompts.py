"""Prompt construction for in-context next-step prediction.

Parity surface: llama_meta.py:88-159 —

  * four context styles ({init, input, output} strings keyed default /
    unreferenced / elaborate / no-context, shipped as
    data/context_prompt/context_prompt.json; embedded here as defaults);
  * per-step prompt:
      "{context}{init} {toy}\n{input}\n {', '.join(['-1'|'👉'] + hist)}\n{output}\n"
    rebuilt from scratch at every step (llama_meta.py:118-159; the llm_hf
    variant instead accumulates blocks across steps — exposed as
    ``accumulate=True``);
  * emoji mode replaces the "-1" start token with 👉 throughout the context
    (llama_meta.py:110-112) and the history start token;
  * toy-class rewriting: every "Sequence type: XXX\n" in the context is
    replaced with the superclass and "Symbol" -> "Sequence"
    (remove_sequenceInput, llama_meta.py:88-99).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

START_TOKEN_NUM = "-1"
START_TOKEN_EMOJI = "\U0001f449"  # 👉

# data/context_prompt/context_prompt.json contents (spec data, 4 styles)
DEFAULT_CONTEXT_STYLES: Dict[str, Dict[str, str]] = {
    "default": {
        "init": "Sequence type:",
        "input": "Input Sequence:",
        "output": "Next Symbol:",
    },
    "unreferenced": {"init": "Context:", "input": "Input:", "output": "Output:"},
    "elaborate": {
        "init": "Given the sequences of the following:",
        "input": "Complete the following sequence:",
        "output": "Sequence is completed with:",
    },
    "no-context": {"init": "Sequence type:", "input": "", "output": ""},
}


def load_context_styles(path: Optional[str] = None) -> Dict[str, Dict[str, str]]:
    if path is None:
        return DEFAULT_CONTEXT_STYLES
    with open(path) as f:
        return json.load(f)


def remove_sequence_input(prompt: str, toy_class: str) -> str:
    """Rewrite per-toy sequence types to the toy superclass (llama_meta.py:88-99)."""
    new_prompt = ""
    start = 0
    for m in re.finditer(r"Sequence type: [a-zA-Z0-9]{3,}\n", prompt):
        new_prompt += prompt[start : m.start()]
        new_prompt += f"Sequence type: {toy_class}\n"
        start = m.end()
    new_prompt += prompt[start:]
    return new_prompt.replace("Symbol", "Sequence")


@dataclass
class PromptBuilder:
    """Builds the per-step completion prompt for one video's sequence."""

    context: str  # few-shot in-context examples for this toy / dataset
    toy: Optional[str] = None
    toy_class: Optional[str] = None
    type_prompt: str = "num"  # num | alpha | emoji
    prompt_context: str = "default"
    styles: Optional[Dict[str, Dict[str, str]]] = None
    accumulate: bool = False  # llm_hf.py growth behavior; llama_meta rebuilds

    def __post_init__(self):
        styles = self.styles or DEFAULT_CONTEXT_STYLES
        self.style = styles[self.prompt_context]
        context = self.context
        if self.type_prompt == "emoji":
            context = context.replace(START_TOKEN_NUM, START_TOKEN_EMOJI)
        if self.toy_class:
            context = remove_sequence_input(context, self.toy_class)
        self.prepared_context = context
        header_subject = self.toy_class if self.toy_class else self.toy
        self._header = f"{self.prepared_context}{self.style['init']} {header_subject}\n"
        self._accumulated = self._header

    @property
    def start_token(self) -> str:
        return START_TOKEN_EMOJI if self.type_prompt == "emoji" else START_TOKEN_NUM

    def history(self, seq: Sequence, i: int) -> List:
        hist: List = [self.start_token if self.type_prompt == "emoji" else -1]
        hist += list(seq[:i])
        return hist

    def step_prompt(self, seq: Sequence, i: int) -> str:
        hist = self.history(seq, i)
        block = (
            f"{self.style['input']}\n {', '.join(map(str, hist))}\n"
            f"{self.style['output']}\n"
        )
        if self.accumulate:
            self._accumulated += block
            return self._accumulated
        return self._header + block


def symbolize_sequence(
    seq: Sequence[int],
    type_prompt: str,
    idx2action: Optional[Dict[int, str]] = None,
    idx2emoji: Optional[Dict[str, Dict[str, str]]] = None,
) -> List:
    """Map class-id sequences to the prompt symbol space (llama_meta.py:305-310)."""
    if type_prompt == "alpha":
        if idx2action is None:
            raise ValueError("alpha prompts require idx2action")
        return [idx2action[s] for s in seq]
    if type_prompt == "emoji":
        if idx2emoji is None:
            raise ValueError("emoji prompts require idx2emoji")
        return [idx2emoji[str(s)]["escape"] for s in seq]
    return list(seq)
