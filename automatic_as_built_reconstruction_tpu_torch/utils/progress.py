"""Scoped timers.

The port's copy of the JAX package's ``utils/progress.py::StageTimers``:
named accumulating timers for per-stage ms reports (the trainer's
host-prep / feed / step split).  The text progress bar has no caller in
the port.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class StageTimers:
    """Named accumulating timers for per-stage ms reports.

    Device work must be synchronised before the ``with`` block ends for
    the time to include it (CUDA launches return before the card is
    done).
    """

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def means_ms(self) -> Dict[str, float]:
        return {k: self._totals[k] / max(self._counts[k], 1) * 1000
                for k in self._totals}

    def clear(self):
        self._totals.clear()
        self._counts.clear()
