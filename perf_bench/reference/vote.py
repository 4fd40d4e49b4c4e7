"""TI-PREGO's aggregation and PREGO's one-class verdict, written out again:
the modal class of every completed window of 200 frames (the lowest id
on ties, as ``np.bincount(...).argmax()``), consecutive repeats dropped;
each new step is checked against the steps before it, and a step the
anticipation did not name is a mistake."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def window_checks(ids: np.ndarray, sequence: List[int], frame0: int, window: int,
                  stream: int) -> List[Dict]:
    """The checks a stream's ids (frames of whole windows, in order) raise:
    {stream, frame_index, step, history}; ``sequence`` (the stream's steps
    so far) is extended in place."""
    out = []
    for w in range(len(ids) // window):
        votes = ids[w * window:(w + 1) * window]
        winner = int(np.bincount(votes).argmax())
        if not sequence or sequence[-1] != winner:
            out.append({"stream": stream, "frame_index": frame0 + (w + 1) * window,
                        "step": winner, "history": list(sequence)})
            sequence.append(winner)
    return out


def verdict(step: int, anticipated: Sequence) -> bool:
    """The one-class rule: a mistake where the step was not anticipated."""
    return step not in set(anticipated)
