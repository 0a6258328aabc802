"""Drivers: one module per kind of traffic, named by a mix's "driver" key.

A driver module defines `Session(cell, device)`, which builds the program
once, with `prepare(seed)` (weights and data from the seed, warm-up: the
set-up), `window(seconds, tracer)` (the measured window; returns an
`Outcome`), `release()` (frees the program's state), `reference(prec)` and
`compare(reference_readings)` (the numbers that decide `correct`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Outcome"]


@dataclasses.dataclass
class Outcome:
    """A measured window: the cell's end-to-end values (setup_s apart), the
    work attempted and failed, when it opened (`t0`, host clock), how long
    it lasted and how many steps it completed, with the steps' times where
    the driver takes them and the chains it finished."""

    metrics: dict
    attempted: int
    failed: int
    t0: float
    window_s: float
    steps: int
    step_ms: list = dataclasses.field(default_factory=list)
    finished: Optional[int] = None
