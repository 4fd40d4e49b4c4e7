"""One closed loop a kind of traffic: a class ``Loop(cell, seed,
device)`` with:

  setup()                 builds the system under test from the seed and
                          warms up the shapes the cell uses
  window(seconds, tracer) runs the closed loop for ``seconds``, tracing
                          its first ``trace_units`` units where a tracer is
                          given
  end_to_end()            {metric: (value, unit)} of the window
  release()               frees the program's state
  check()                 the comparisons that decide ``correct`` (a list
                          of ``Check``), once the window has closed
  close()                 removes what set-up wrote
  attempted, failed       the units of work the window attempted and lost
  unit_seconds, unit_work the host clock and the work (checks, windows) of
                          each unit of the window

The per-layer metric readers receive the loop itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class Check:
    """One number compared with its limit: ok where value <= limit."""

    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return (self.limit is not None and not math.isnan(self.value)
                and self.value <= self.limit)


def limit_of(limits: dict, name: str) -> Optional[float]:
    entry = limits.get(name)
    return None if entry is None else entry.get("limit")
