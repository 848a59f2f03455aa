"""The machinery every traffic kind drives (``benchmark.mix``): frames
dispatched into the program, their answers collected oldest first, and
every frame timed on the host's clock: when it fell due (a closed loop:
when it was dispatched), how long its dispatch took, and when its answers
reached host memory: the device time of the event behind their copies,
put on the host's clock by an event the window starts with (the
single-threaded loop may notice them later, while it dispatches the next
frame; a consumer of the answers need not wait for that). The frames of a
window are those due in it; after it closes the loop waits for the ones
still in flight (up to ``drain_s``), so a late answer is timed, not lost.
Nothing here belongs to one mix: when frames fall due is the kind's.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

clock = time.perf_counter


@dataclass
class Frame:
    index: int
    pool: int
    due: float
    start: float = 0.0  # dispatch began
    end: float = 0.0  # dispatch returned
    done: float | None = None  # answers seen on the host
    answers: tuple | None = field(default=None, repr=False)  # (flag, verdict, area, found)


class Loop:
    """Runs frames of ``program`` over ``pool``, frame ``i`` taking capture
    ``i % len(pool)``. A ``tracer`` is told before each dispatch and names
    the loop's phases to the profiler."""

    def __init__(self, program, pool, tracer=None):
        self.program, self.pool = program, pool
        self.tracer = tracer
        self.frames: list[Frame] = []
        self.last: dict[int, tuple] = {}  # pool capture -> its last pass's device outputs
        self.inflight: deque = deque()
        self._anchor = None  # (an event, the host time it completed)

    def mark(self) -> None:
        """Put the device's event times on the host's clock."""
        if self.pool[0].device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            e.synchronize()
            self._anchor = (e, clock())

    def phase(self, name: str):
        return self.tracer.annotate(name) if self.tracer else contextlib.nullcontext()

    def dispatch(self, due: float) -> None:
        if self.tracer:
            self.tracer.before_dispatch()
        k = len(self.frames)
        p = k % len(self.pool)
        with self.phase("bench.dispatch"):
            fr = Frame(k, p, due, start=clock())
            flight = self.program.dispatch(k, p, self.pool[p])
            fr.end = clock()
        self.frames.append(fr)
        self.inflight.append((fr, flight))

    def collect(self) -> None:
        fr, flight = self.inflight.popleft()
        fr.done = clock()
        if self._anchor is not None and flight.event is not None:
            e, t = self._anchor
            fr.done = min(fr.done, t + e.elapsed_time(flight.event) * 1e-3)
        with self.phase("bench.answers"):
            fr.answers = self.program.answers(flight)
        self.last[fr.pool] = flight.device

    def step(self, in_flight: int) -> None:
        """Dispatch a frame if fewer than ``in_flight`` are in flight, else
        await the oldest and collect it."""
        if len(self.inflight) < in_flight:
            self.dispatch(clock())
            return
        with self.phase("bench.wait"):
            self.inflight[0][1].wait()
        self.collect()

    def collect_done(self) -> None:
        """Collect, oldest first, every frame whose answers have arrived,
        without waiting."""
        while self.inflight and self.inflight[0][1].done():
            self.collect()

    def drain(self, limit_s: float) -> None:
        """Collect what is still in flight, waiting up to ``limit_s``."""
        stop = clock() + limit_s
        while self.inflight and clock() < stop:
            self.collect_done()
        self.inflight.clear()

    def window(self, t0: float, t1: float) -> list[Frame]:
        return [f for f in self.frames if t0 <= f.due < t1]


def p95(values) -> float:
    """The 95th percentile by the nearest rank (numpy's 'inverted_cdf')."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95, method="inverted_cdf"))
