"""Captured replays of the one-capture program (CUDA graphs).

A line inspects every capture with the same program: one grid, one recipe,
one anchor set. On the card the host's dispatch of that program (its torch
ops and kernel wrappers) takes longer than the card's work, so
:func:`tpu_inspect_torch.engine._inspect_image_device` hands each CUDA frame
(of every route) to :data:`FRAMES` under a key of everything the program
bakes in (``engine._frame_key``). The first
``CAPTURE_AT - 1`` sightings of a key run eagerly; the next one captures
the program into a ``torch.cuda.CUDAGraph`` (warmed up, then captured, on
a side stream, into a private memory pool), and from then on each frame of
the key:

1. copies the caller's image into the graph's static input;
2. replays the graph, whose first node zeroes the graph's own bound flag;
3. merges that flag into the caller's (:func:`merge_flag`: a set flag stays
   set) and returns clones of the graph's static outputs, so the caller
   owns them as it owns an eager frame's.

Nothing in a replay waits for the card; the capture waits for it once
(``torch.cuda.graph`` synchronizes the device and frees cached memory
before it captures). The kernels, their launches and
the arithmetic are those of the eager program, so the outputs are the same
bits. A replay opens the span ``graph.replay`` and no stage or ``kernel.*``
span (its host does no such work), a capture ``graph.capture`` (with the
warm-up's and the capture's spans inside it); both lie inside the frame's
root span. ``LAUNCHES`` grows on each replay by the launches the capture
recorded (:func:`tpu_inspect_torch.kernels.recording`: the capturing
thread's own, whatever other threads launch meanwhile), and ``GRAPHS``
counts captures, replays, eager frames and refused captures
(:mod:`tpu_inspect_torch.kernels`).

A graph holds what it reads from outside its pool: the static input and
flag, the tensors its key names (the origins), and every
:func:`tpu_inspect_torch.kernels.device_constant` the capture read. At
most :data:`MAX_KEYS` keys are kept, the least recently used dropped with
its graph and pool. A capture that raises refuses its key, which runs
eagerly from then on; the refusal is counted and warned of.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from collections import OrderedDict

import torch

from tpu_inspect_torch.kernels import GRAPHS, LAUNCHES, error_flag, recording
from tpu_inspect_torch.utils.trace import span

CAPTURE_AT = 3  # the sighting of a key that captures its graph
MAX_KEYS = 4  # keys kept, least recently used dropped first


def merge_flag(err: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """The caller's bound flag ``err`` raised to ``flag`` in place (their
    maximum): a flag already set is never cleared."""
    return torch.maximum(err, flag, out=err)


def _clone(outs):
    """The program's outputs (tensors, None, nested tuples) cloned, nested
    as they were."""
    if isinstance(outs, tuple):
        return tuple(_clone(o) for o in outs)
    return None if outs is None else outs.clone()


class _Entry:
    """One key: its sightings, what it holds, and its graph once captured."""

    __slots__ = ("seen", "keep", "refused", "graph", "image", "flag", "outs", "launches")

    def __init__(self, keep):
        self.seen, self.keep, self.refused = 0, list(keep), False
        self.graph = self.image = self.flag = self.outs = None
        self.launches: dict[str, int] = {}


class FrameGraphs:
    """The captured graphs of the one-capture program, by frame key."""

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.last_refusal: str | None = None  # the last refused capture's traceback

    def keys(self) -> list:
        """The keys kept, least recently used first."""
        return list(self._entries)

    def clear(self) -> None:
        """Drop every key with its graph, and the last refusal."""
        with self._lock:
            self._entries.clear()
            self.last_refusal = None

    def sight(self, key, keep=()) -> tuple[_Entry, str]:
        """Count one sighting of ``key`` (its entry made on the first, holding
        ``keep``) -> (the entry, what the frame does: ``"eager"``,
        ``"capture"`` or ``"replay"``). Touches no device."""
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(keep)
            while len(self._entries) > MAX_KEYS:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(key)
        if entry.graph is not None:
            return entry, "replay"
        entry.seen += 1
        if entry.refused or entry.seen < CAPTURE_AT:
            return entry, "eager"
        return entry, "capture"

    def run(self, key, image: torch.Tensor, err: torch.Tensor, program, keep=()):
        """One frame of ``program(image, err)`` (a CUDA image, the caller's
        bound flag ``err``) under ``key``: eager, captured then replayed, or
        replayed; eager always with ``key`` None. ``keep``: what the key
        names and a graph reads. Returns the program's outputs, the caller's
        own."""
        with self._lock:
            entry, action = (None, "eager") if key is None else self.sight(key, keep)
            if action == "capture":
                with span("graph.capture"):
                    action = "replay" if self._capture(entry, image, program) else "eager"
            if action == "replay":
                with span("graph.replay"):
                    entry.image.copy_(image)
                    entry.graph.replay()
                    merge_flag(err, entry.flag)
                    for name, n in entry.launches.items():
                        LAUNCHES[name] += n
                    GRAPHS["replayed"] += 1
                    return _clone(entry.outs)
            GRAPHS["eager"] += 1
        return program(image, err)

    def _capture(self, entry: _Entry, image: torch.Tensor, program) -> bool:
        """Warm ``program`` up on a side stream, then capture it into a graph
        of ``entry``'s; False (the key refused, counted) if either raised.
        The launches of both go to records of this thread's
        (:func:`tpu_inspect_torch.kernels.recording`), the capture's kept as
        what each replay counts; ``LAUNCHES`` is left to other threads."""
        dev = image.device
        launches: dict[str, int] = {}
        try:
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                entry.image = torch.empty(image.shape, dtype=image.dtype, device=dev)
                entry.image.copy_(image)
                entry.flag = error_flag(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with recording([], {}), torch.cuda.stream(side):
                    program(entry.image, error_flag(dev))
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with recording(entry.keep, launches), torch.cuda.graph(
                        graph, stream=side, capture_error_mode="thread_local"):
                    entry.flag.zero_()
                    entry.outs = program(entry.image, entry.flag)
            entry.launches = launches
            entry.graph = graph
            GRAPHS["captured"] += 1
            return True
        except Exception as e:  # noqa: BLE001 - any failure refuses the key
            self.last_refusal = traceback.format_exc()
            warnings.warn(f"CUDA graph capture refused, the frame key runs eagerly: {e!r}",
                          RuntimeWarning, stacklevel=3)
            entry.refused = True
            entry.image = entry.flag = entry.outs = None
            GRAPHS["refused"] += 1
            return False


FRAMES = FrameGraphs()
