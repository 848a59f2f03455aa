"""Spans of the port's host time, off by default.

``with span(name):`` times what the host does inside it. Off, ``span``
checks one module flag and returns the same shared null context every
time: nothing is made and nothing recorded. On (:func:`enable`), each span
that closes records ``(frame_id, parent, name, t0_ns, t1_ns)`` on
``time.perf_counter_ns()``:

- a span opened while none is open is a root: it takes the next frame id,
  and every span opened inside it shares that id;
- ``parent`` is the path of the enclosing spans (``"frame.split/seg.tail"``),
  ``""`` for a root.

Records are kept in memory, the newest :data:`CAPACITY`: a full buffer
drops its oldest record and counts the drop in :data:`dropped`. Spans nest
on one stack for the process, so trace one dispatching thread at a time.

The spans the port opens (PERF.md, section 3, names the metric each is
read for):

- a call of :func:`tpu_inspect_torch.engine._inspect_image_device` is a
  root named by its route: ``frame.chained`` (kernel K on a
  reference-aligned otsu frame), ``frame.split``, or ``frame.whole`` (the
  whole-image route); under it the stages ``gather``, ``seg.head``,
  ``seg.align``, ``seg.tail``, ``defect.roi``, ``defect.cand`` and
  ``defect.filter`` (on the whole-image route, ``whole.mask``,
  ``whole.fill``, ``whole.label`` and ``whole.stats`` inside ``seg.tail``
  and ``defect.roi``; ``whole.mask``, ``whole.regions`` and
  ``whole.select`` inside ``defect.filter``), or, for a frame of a
  captured graph (:mod:`tpu_inspect_torch.graphs`), ``graph.replay``
  alone (the host does no stage's work there) or ``graph.capture`` (the
  warm-up's and the capture's stages inside it);
- ``kernel.<name>`` around each call of a hand kernel's wrapper, ``<name>``
  its key in :data:`tpu_inspect_torch.kernels.LAUNCHES`
  (:class:`tpu_inspect_torch.kernels.Kernel`);
- ``stream.upload`` (with ``stream.slot_wait`` and ``stream.copy``, the
  copy into the pinned slot, inside it) and ``stream.fetch`` in
  :func:`tpu_inspect_torch.streaming.stream_inspect`; the copy's worker
  threads open no span;
- the name given to :func:`tpu_inspect_torch.utils.logging.stage_timer`.

A frame's glue is its root span less the ``kernel.*`` spans inside it;
its kernel time is the sum of those spans.
"""

from __future__ import annotations

from collections import deque
from contextlib import nullcontext
from time import perf_counter_ns

CAPACITY = 1 << 18  # records kept; reset() takes a new value
dropped = 0  # records dropped from the full buffer since the last reset()

_on = False
_records: deque = deque(maxlen=CAPACITY)
_stack: list = []  # the open spans, innermost last
_last_id = 0
_NULL = nullcontext()


class _Span:
    __slots__ = ("name", "frame", "parent", "path", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _last_id
        if _stack:
            top = _stack[-1]
            self.frame, self.parent = top.frame, top.path
            self.path = f"{top.path}/{self.name}"
        else:
            _last_id += 1
            self.frame, self.parent, self.path = _last_id, "", self.name
        _stack.append(self)
        self.t0 = perf_counter_ns()
        return None

    def __exit__(self, *exc):
        global dropped
        t1 = perf_counter_ns()
        _stack.pop()
        if len(_records) == _records.maxlen:
            dropped += 1
        _records.append((self.frame, self.parent, self.name, self.t0, t1))
        return False


def span(name: str):
    """A context that records the host time inside it as span ``name``
    while tracing is on; off, the shared null context."""
    if not _on:
        return _NULL
    return _Span(name)


def enable(on: bool = True) -> None:
    """Turn spans on or off. Spans already open close as they were made."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Drop every record and the drop count; the buffer takes
    :data:`CAPACITY` anew. Frame ids keep counting."""
    global _records, dropped
    _records = deque(maxlen=CAPACITY)
    dropped = 0


def records() -> list[tuple[int, str, str, int, int]]:
    """The records kept, oldest first: (frame_id, parent, name, t0_ns,
    t1_ns)."""
    return list(_records)
