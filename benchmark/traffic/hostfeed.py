"""Host-fed closed loop: the line PC's frame grabber hands each capture to
host memory, and the port's own stream (``streaming.stream_inspect``) takes
it from there: it copies the capture into one of its reused pinned upload
slots, enqueues the upload and the frame's program while earlier frames
compute, and fetches the oldest frame's verdicts, areas and found flags
with a blocking copy once ``in_flight`` frames are in (prefetch
``in_flight`` - 1). No anchors, so every frame is reference-aligned.

The captures are the seed's pool, made on the card as in the other cells
and held on the host as pageable numpy arrays, fed in turn. A frame falls
due when the stream pulls its capture from this kind's iterator, and is
answered when its result is yielded; a frame the stream refuses (its bound
flag set) ends the window unanswered. After the window one pass of the
same stream with ``fetch_masks`` gives each capture's masks to the
comparison (the stream returns no shifts: reference-aligned frames have
none).

A ``--trace 1`` run turns the port's spans on for the window
(``benchmark.spans``): each frame gets its spans' summary, and each
profiled slice the window's span records and clock anchors taken at its
start and just before its end. Parameters: ``pool``, ``in_flight``.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from benchmark import spans
from benchmark import trace as bench_trace
from benchmark.loop import Frame, clock
from benchmark.mix import Mix



def _slice_frames(name: str) -> int:
    """The frames the tracer takes in its slice ``name``."""
    return {"device": bench_trace.DEVICE_SLICE_FRAMES,
            "host": bench_trace.HOST_SLICE_FRAMES}.get(name, 0)


def _port_trace():
    """The port's span module, or None where the port has none."""
    try:
        from tpu_inspect_torch.utils import trace
    except ImportError:
        return None
    return trace


def _refused(e: RuntimeError) -> None:
    """Re-raise ``e`` unless the stream refused a frame (its bound flag,
    :func:`tpu_inspect_torch.kernels.build.check_bounded`)."""
    if "error flag" not in str(e):
        raise e


class Kind(Mix):
    def prepare(self, program, pool):
        self.program = program
        self.host = [t.cpu().numpy() for t in pool]  # pageable host memory
        self.anchors: dict[str, list] = {}

    def _stream(self, captures, fetch_masks: bool):
        from tpu_inspect_torch import streaming

        p = self.program
        return streaming.stream_inspect(
            captures, p.grid, p.seg, p.defect, p.exclusions, None,
            prefetch=self.traffic["in_flight"] - 1, fetch_masks=fetch_masks, device=p.device)

    def _before_dispatch(self, tracer) -> None:
        """The tracer's turn before a frame, with a clock anchor in each
        slice right after it starts and just before it stops."""
        names = list(tracer.slices)
        if names:
            s = tracer.slices[names[-1]]
            if s.wall_s == 0 and s.frames >= _slice_frames(names[-1]):
                self.anchors.setdefault(names[-1], []).append(spans.anchor())
        tracer.before_dispatch()
        if len(tracer.slices) > len(names):
            self.anchors[list(tracer.slices)[-1]] = [spans.anchor(), spans.anchor()]

    def drive(self, loop, until) -> None:
        """Frames of the pool in turn through the stream until ``until()``
        holds when the stream asks for the next capture; each is appended
        to ``loop.frames`` with its timing and answers (the dispatch runs
        inside the stream, so a frame's ``end`` is not taken)."""
        pending: deque[Frame] = deque()

        def captures():
            while True:
                if until():
                    return
                if loop.tracer is not None:
                    self._before_dispatch(loop.tracer)
                k = len(loop.frames)
                now = clock()
                fr = Frame(k, k % len(self.host), now, start=now)
                loop.frames.append(fr)
                pending.append(fr)
                yield self.host[fr.pool]

        try:
            for res in self._stream(captures(), fetch_masks=False):
                fr = pending.popleft()
                fr.done = clock()
                fr.answers = (np.zeros(1, np.int32), res.verdicts, res.areas, res.valid)
        except RuntimeError as e:
            _refused(e)
            pending[0].answers = (np.ones(1, np.int32), None, None, None)

    def warm(self, loop, n):
        self.drive(loop, lambda: len(loop.frames) >= n)

    def run(self, loop, seconds):
        trace = _port_trace() if loop.tracer is not None else None
        if trace is not None:
            trace.reset()
            trace.enable(True)
        t0 = clock()
        t1 = t0 + seconds
        try:
            self.drive(loop, lambda: clock() >= t1)
        finally:
            if trace is not None:
                trace.enable(False)
        if trace is not None:
            recs = trace.records()
            trace.reset()
            spans.assign(loop.frames, recs)
            for name, sl in loop.tracer.slices.items():
                sl.spans, sl.anchors = recs, self.anchors.get(name, [])
        self._last_masks(loop)
        return t0, t1

    def _last_masks(self, loop) -> None:
        """One pass of the stream over the pool with its masks fetched (up
        to a frame it refuses, which the window has already counted)."""
        try:
            for res in self._stream(iter(self.host), fetch_masks=True):
                u = res.verdicts.shape[0]
                loop.last[res.index] = (torch.from_numpy(res.seg_masks),
                                        torch.zeros((u, 2), dtype=torch.int32),
                                        torch.from_numpy(res.defect_masks))
        except RuntimeError as e:
            _refused(e)
