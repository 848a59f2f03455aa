"""The port's hand-written CUDA kernels: build, binding and launch counts.

``LAUNCHES`` counts, per kernel, the launches its wrapper made (a plain
integer per name, incremented where the wrapper launches the kernel and
nowhere else), so a run can show that the main path went through the
kernels. Reset it with :func:`reset_launches`. The helper that counts a
launch, :class:`Kernel`, is the one that opens the wrapper's span
(``kernel.<name>`` of :mod:`tpu_inspect_torch.utils.trace`): one record of
the kernels, counts and host time alike. A frame replayed from a captured
graph (:mod:`tpu_inspect_torch.graphs`) counts the launches its capture
recorded, so it counts as an eager frame does; the launches made while a
thread warms up or captures a graph go to that capture's record
(:func:`recording`), never to ``LAUNCHES``, so frames that other threads
run meanwhile count as they would alone.

``GRAPHS`` counts what the frames of the one-capture program did on the
card: ``captured`` graphs, ``replayed`` and ``eager`` frames, and captures
``refused`` (whose key runs eagerly from then on). Reset it with
:func:`reset_graphs`.

:func:`device_constant` caches a small tensor a kernel or the program reads
on every call (a stage program, taps, index tables, the anchors); while a
thread captures a graph it also hands each value to the graph's keep list
(:func:`recording`), so the cache's eviction cannot free what a graph reads.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from tpu_inspect_torch.utils import trace

LAUNCHES: dict[str, int] = {
    "seg_tail": 0, "median_residual": 0, "blob_filter": 0, "propagate": 0, "label": 0,
    "cc_stats": 0, "blob_select": 0, "median_blur": 0, "morph": 0, "label_stats": 0,
    "seg_roi_tail": 0, "median_probe": 0, "otsu": 0, "gauss_blur": 0, "adaptive": 0,
    "canny_head": 0,
}


GRAPHS: dict[str, int] = {"captured": 0, "replayed": 0, "eager": 0, "refused": 0}

_LOCAL = threading.local()  # .record: this thread's capture record (keep, launches), or None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_graphs() -> None:
    for name in GRAPHS:
        GRAPHS[name] = 0


def device_constant(maxsize: int | None):
    """``functools.lru_cache(maxsize)`` for a function that returns a device
    constant (a tensor, or a tuple of them, never written in place). Inside
    :func:`recording` every value it returns on that thread is also
    appended to the keep list. The wrapper keeps ``cache_clear`` and
    ``cache_info``."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            out = cached(*args, **kwargs)
            record = getattr(_LOCAL, "record", None)
            if record is not None:
                record[0].append(out)
            return out

        get.cache_clear, get.cache_info = cached.cache_clear, cached.cache_info
        return get

    return wrap


@contextlib.contextmanager
def recording(keep: list, launches: dict[str, int]):
    """On this thread, inside the block: append every :func:`device_constant`
    value returned to ``keep``, and count each kernel launch in
    ``launches`` in place of ``LAUNCHES`` (a graph's warm-up and capture:
    the graph then holds what it reads, and its replays count what it
    launched). Other threads count as before."""
    outer = getattr(_LOCAL, "record", None)
    _LOCAL.record = (keep, launches)
    try:
        yield
    finally:
        _LOCAL.record = outer


class Kernel:
    """The bookkeeping of hand kernel ``name`` (a key of ``LAUNCHES``).
    Decorating a wrapper with it runs each call of the wrapper, from its
    first check to its launch's return (the plain version on the CPU), in
    the span ``kernel.<name>``; :meth:`launched` counts one launch, where
    the wrapper has launched and nowhere else."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        if name not in LAUNCHES:
            raise KeyError(f"no kernel {name!r} in LAUNCHES")
        self.name, self.span = name, f"kernel.{name}"

    def __call__(self, wrapper):
        span = self.span

        @functools.wraps(wrapper)
        def spanned(*args, **kwargs):
            with trace.span(span):
                return wrapper(*args, **kwargs)

        return spanned

    def launched(self) -> None:
        record = getattr(_LOCAL, "record", None)
        if record is None:
            LAUNCHES[self.name] += 1
        else:
            record[1][self.name] = record[1].get(self.name, 0) + 1


def error_flag(device) -> torch.Tensor:
    """A zeroed [1] int32 device flag for kernels that check a bound: they
    set it instead of returning a wrong plane. Pass one flag to several
    launches and read it once where the results are copied out anyway
    (:func:`tpu_inspect_torch.kernels.build.check_bounded`); a wrapper given
    none makes its own and reads it right after its launch."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def check_planes(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is a contiguous [U, H, W] uint8 tensor on the CPU
    or a CUDA device (what every kernel wrapper takes)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous [U, H, W] uint8 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def as_planes(x: torch.Tensor, name: str) -> torch.Tensor:
    """:func:`check_planes` for uint8 or bool planes: a bool tensor is read
    as its uint8 bytes (0/1) without a copy. Returns the uint8 view."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    check_planes(x, name)
    return x


def check_vector(v: torch.Tensor, name: str, u: int, device) -> None:
    """Raise unless ``v`` is a contiguous [u] int32 tensor on ``device``."""
    if (v.dtype != torch.int32 or tuple(v.shape) != (u,)
            or not v.is_contiguous() or v.device != device):
        raise ValueError(
            f"{name}: expected a contiguous [{u}] int32 tensor on {device}, got "
            f"{v.dtype} {tuple(v.shape)} on {v.device}"
        )


def check_labels(labels: torch.Tensor, like: torch.Tensor, name: str) -> None:
    """Raise unless ``labels`` is a contiguous int32 tensor of ``like``'s
    shape on ``like``'s device (a label plane a kernel reads)."""
    if (labels.dtype != torch.int32 or labels.shape != like.shape
            or not labels.is_contiguous() or labels.device != like.device):
        raise ValueError(
            f"{name}: expected a contiguous int32 {tuple(like.shape)} tensor on "
            f"{like.device}, got {labels.dtype} {tuple(labels.shape)} on {labels.device}"
        )
