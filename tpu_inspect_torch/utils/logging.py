"""Observability: the reference's log-pane messages + device stage timing.

A copy of :mod:`tpu_inspect.utils.logging` (the same message formats).

The reference's only observability is a 1000-line text pane with per-unit
messages like ``Unit {row}: defect area={area} px -> {NG|OK}``
(indexing_ui.py:1619, :977-983) and status-bar summaries (:1626, :1708).
InspectionLog reproduces those message formats headlessly; stage_timer adds
what the reference never had — wall-clock timing around stages, each also a
span of :mod:`tpu_inspect_torch.utils.trace` (the port's one timing system).
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

from tpu_inspect_torch.utils import trace


class InspectionLog:
    """Append-only capped log (the reference caps at 1000 blocks)."""

    def __init__(self, max_lines: int = 1000):
        self.lines: deque[str] = deque(maxlen=max_lines)

    def log(self, msg: str) -> None:
        self.lines.append(str(msg))

    def unit_verdict(self, row: int, area: int, min_area: int) -> None:
        verdict = "NG" if area >= min_area else "OK"
        self.log(f"Unit {row}: defect area={area} px -> {verdict}")

    def unit_no_defects(self, row: int) -> None:
        self.log(f"Unit {row}: no defects")

    def batch_summary(self, processed: int, count: int) -> None:
        self.log(f"Defect detection completed: {processed}/{count} units had detections")

    def inspection_summary(self, ng: int, count: int) -> None:
        self.log(f"Inspection complete: {ng}/{count} units NG")

    def tail(self, n: int = 20) -> list[str]:
        return list(self.lines)[-n:]


@contextmanager
def stage_timer(name: str, sink=None):
    """Wall-clock timing context, opened as span ``name`` of
    :mod:`tpu_inspect_torch.utils.trace`; appends ``name: X.X ms`` to
    sink/log."""
    t0 = time.perf_counter()
    try:
        with trace.span(name):
            yield
    finally:
        ms = (time.perf_counter() - t0) * 1000.0
        msg = f"{name}: {ms:.1f} ms"
        if sink is not None:
            (sink.log if hasattr(sink, "log") else sink)(msg)
