"""Streaming multi-image inline inspection (BASELINE.json config 5).

The port of :mod:`tpu_inspect.streaming`. The reference inspects one image
at a time behind UI buttons; production deployment is a camera stream.
Each frame is uploaded from a reused pinned host buffer with a non-blocking
copy and its program (:func:`tpu_inspect_torch.engine._inspect_image_device`)
is dispatched while earlier frames are still computing: up to ``prefetch``
frames are in flight before the oldest one's results are fetched.

The program waits for the card nowhere: the Otsu threshold stays on the
device (``ops/threshold.py``), and the frame's bound flag is read with its
answers. So a frame's upload and dispatch overlap the card's work on the
frames before it; the host waits only where it refills an upload slot
(span ``stream.slot_wait``) and where it fetches the oldest frame's answers
(``stream.fetch``). A stream's frames share one grid, recipe and anchor
set, so from its third frame on the card the program is a replay of one
captured CUDA graph (:mod:`tpu_inspect_torch.graphs`): the dispatch is a
copy of the uploaded capture, one launch and the answers' copies, and
``stream.fetch`` then holds most of the host's wait for the card.

A capture reaches its pinned slot in row bands copied in parallel
(:func:`_copy_rows`): a band for each MiB begun, at most one a core the
process may run on and :data:`_MAX_BANDS`, on a pool of native threads
made once per process and shared by every stream, the calling thread one
of them (:func:`tpu_inspect_torch.native.copy_bands`: Python threads would
start their bands one after another, each once it holds the GIL). A
capture of 1 MiB or less, a process on one core, or a host without the
native library copies on the calling thread alone. :data:`UPLOADS` counts
both kinds of copy and the bands; reset it with :func:`reset_uploads`.

Spans (:mod:`tpu_inspect_torch.utils.trace`, off by default):
``stream.upload`` a frame, ``stream.slot_wait`` and ``stream.copy`` (the
copy into the pinned slot, on the calling thread; the workers open no span)
inside it, the frame's program as its ``frame.*`` root, and
``stream.fetch``.

Verdicts, areas and found flags (a few hundred bytes) are fetched per
frame; masks stay on the device unless ``fetch_masks`` asks for them
(fetching 48 full masks costs more than computing them).

:func:`stream_inspect_sharded` is the multi-GPU loop: frames in batches of
a rank mesh's image axis, each batch inspected with both axes sharded
(:mod:`tpu_inspect_torch.parallel`).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

from tpu_inspect_torch import native
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.device import resolve_device
from tpu_inspect_torch.engine import _inspect_image_device, origins_on, ref_centroid_arrays
from tpu_inspect_torch.kernels import build, error_flag
from tpu_inspect_torch.utils.trace import span


@dataclass
class StreamResult:
    index: int
    verdicts: np.ndarray  # [U] bool
    areas: np.ndarray  # [U] int64
    valid: np.ndarray  # [U] bool (defect mask exists)
    ng_count: int
    seg_masks: np.ndarray | None = None  # [U, h, w] uint8 when requested
    defect_masks: np.ndarray | None = None


UPLOADS: dict[str, int] = {"banded": 0, "single": 0, "bands": 0}
_uploads_lock = threading.Lock()  # streams on several threads count every copy

_BAND_BYTES = 1 << 20  # a band for each MiB of capture begun
_MAX_BANDS = 8  # a fixed ceiling, whatever the cores


def reset_uploads() -> None:
    with _uploads_lock:
        for name in UPLOADS:
            UPLOADS[name] = 0


def _band_edges(rows: int, nbytes: int) -> list[int]:
    """The row edges of the bands a capture of ``rows`` rows and ``nbytes``
    bytes is copied in: one band for each MiB begun, at most one a core of
    ``os.sched_getaffinity`` and :data:`_MAX_BANDS`, never more than
    ``rows``, at least one. Band ``i`` is rows ``[edges[i], edges[i + 1])``."""
    n = max(1, min(-(-nbytes // _BAND_BYTES), len(os.sched_getaffinity(0)), _MAX_BANDS, rows))
    return [rows * i // n for i in range(n + 1)]


def _copy_rows(dst: np.ndarray, src: np.ndarray) -> int:
    """Copy ``src`` into ``dst`` (the same shape and dtype) in the row bands
    of :func:`_band_edges` on the native pool
    (:func:`tpu_inspect_torch.native.copy_bands`), all landed on return.
    One band, a non-contiguous or overlapping array or no native library:
    one copy on the calling thread. Returns the number of bands and counts
    the copy in :data:`UPLOADS`."""
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"copy of {src.dtype}{src.shape} into {dst.dtype}{dst.shape}")
    edges = _band_edges(src.shape[0], src.nbytes)
    bands = len(edges) - 1
    if not (bands > 1 and dst.flags.c_contiguous and dst.flags.writeable
            and src.flags.c_contiguous and not np.may_share_memory(dst, src)
            and native.copy_bands(dst, src, np.array(edges) * (src.nbytes // src.shape[0]))):
        np.copyto(dst, src)
        bands = 1
    with _uploads_lock:
        UPLOADS["banded" if bands > 1 else "single"] += 1
        UPLOADS["bands"] += bands
    return bands


class _Uploader:
    """Frames to the device through ``slots`` reused pinned host buffers.

    A buffer is refilled only after the event recorded behind its last copy
    has completed: refilling it earlier would overwrite a frame the copy
    engine may still be reading; the frame then lands in the buffer in row
    bands (:func:`_copy_rows`, span ``stream.copy``) before one
    non-blocking copy to the device. On the CPU a frame is copied as it
    is. Each frame is a span ``stream.upload``, its wait for the slot's
    event a span ``stream.slot_wait`` inside it.
    """

    def __init__(self, dev: torch.device, slots: int):
        self.dev = dev
        self.slots = max(1, slots)
        self.bufs: list[torch.Tensor | None] = [None] * self.slots
        self.events: list[torch.cuda.Event | None] = [None] * self.slots
        self.n = 0

    def __call__(self, image: np.ndarray) -> torch.Tensor:
        with span("stream.upload"):
            s = self.n % self.slots
            self.n += 1
            with span("stream.slot_wait"):
                if self.events[s] is not None:
                    self.events[s].synchronize()
            if self.dev.type != "cuda":
                return torch.from_numpy(image.copy())
            if self.bufs[s] is None or tuple(self.bufs[s].shape) != image.shape:
                self.bufs[s] = torch.empty(image.shape, dtype=torch.uint8, pin_memory=True)
            with span("stream.copy"):
                _copy_rows(self.bufs[s].numpy(), image)
            out = self.bufs[s].to(self.dev, non_blocking=True)
            self.events[s] = torch.cuda.Event()
            self.events[s].record(torch.cuda.current_stream(self.dev))
            return out


def stream_inspect(
    images: Iterable[np.ndarray],
    grid: GridParams,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids: dict[int, tuple[float, float]] | None = None,
    prefetch: int = 2,
    fetch_masks: bool = False,
    device: str | torch.device = "cuda",
) -> Iterator[StreamResult]:
    """Inspect a stream of grayscale images with pipelined dispatch.

    ``ref_centroids`` (from the reference capture) enables per-unit
    exclusion alignment for every streamed frame; without anchors frames
    are treated as reference-aligned (zero shift), which is also the gate
    of the chained seg+ROI kernel (``engine._ENABLE_CHAIN``).
    """
    dev = resolve_device(device)
    seg = (seg or SegmentationParams()).validated()
    defect = (defect or DefectParams()).validated()
    origins = origins_on(grid, str(dev))
    u = origins.shape[0]
    _, _, w, h = grid.base_unit
    unit_hw = (int(h), int(w))
    _, ref_ok = ref_centroid_arrays(ref_centroids or {}, u)
    is_reference = not bool(ref_ok.any())
    prefetch = max(1, int(prefetch))
    upload = _Uploader(dev, prefetch + 1)

    def dispatch(image):
        err = error_flag(dev)
        masks, _, _, _, (dmasks, found, area, verdict) = _inspect_image_device(
            upload(image), origins, unit_hw, seg, defect, exclusions,
            None if is_reference else ref_centroids, is_reference, True, err,
        )
        return (err, verdict, area, found) + ((masks, dmasks) if fetch_masks else ())

    def collect(i, out):
        with span("stream.fetch"):
            build.check_bounded(f"stream_inspect frame {i}", out[0])
            out = out[1:]
            verdict, area, found = (t.cpu().numpy() for t in out[:3])
            res = StreamResult(
                index=i,
                verdicts=verdict,
                areas=area.astype(np.int64),
                valid=found,
                ng_count=int(verdict.sum()),
            )
            if fetch_masks:
                res.seg_masks = out[3].cpu().numpy()
                res.defect_masks = out[4].cpu().numpy()
            return res

    inflight: deque[tuple[int, tuple]] = deque()
    shape0 = None
    for i, image in enumerate(images):
        image = np.ascontiguousarray(image, dtype=np.uint8)
        # the reference blocks size-mismatched captures once a grid exists
        # (indexing_ui.py:1212-1222); silently clamped crops would inspect
        # the wrong pixels
        if shape0 is None:
            shape0 = image.shape
        elif image.shape != shape0:
            raise ValueError(
                f"frame {i} size {image.shape[::-1]} does not match the "
                f"stream's first frame {shape0[::-1]}"
            )
        inflight.append((i, dispatch(image)))
        while len(inflight) > prefetch:
            j, out = inflight.popleft()
            yield collect(j, out)
    while inflight:
        j, out = inflight.popleft()
        yield collect(j, out)


def stream_inspect_paths(
    paths,
    grid: GridParams,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids: dict[int, tuple[float, float]] | None = None,
    prefetch: int = 2,
    fetch_masks: bool = False,
    decode_ahead: int = 4,
    decode_threads: int = 3,
    device: str | torch.device = "cuda",
) -> Iterator[StreamResult]:
    """:func:`stream_inspect` over image *files*: the native prefetch loader
    (:class:`tpu_inspect_torch.native.StreamLoader`) decodes ahead on C++
    worker threads while the device pipeline runs, so neither libpng/libtiff
    nor the reference's uint16/minmax normalization
    (:func:`tpu_inspect_torch.imageio.load_gray_stream`) stalls the stream.
    The reference decodes synchronously on the UI thread at switch time
    instead (indexing_ui.py:145-194, :1225)."""
    from tpu_inspect_torch.imageio import load_gray_stream

    yield from stream_inspect(
        load_gray_stream(paths, capacity=decode_ahead, threads=decode_threads),
        grid,
        seg,
        defect,
        exclusions=exclusions,
        ref_centroids=ref_centroids,
        prefetch=prefetch,
        fetch_masks=fetch_masks,
        device=device,
    )


def stream_inspect_sharded(
    images: Iterable[np.ndarray],
    grid: GridParams,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids: dict[int, tuple[float, float]] | None = None,
    mesh=None,
    fetch_masks: bool = False,
) -> Iterator[StreamResult]:
    """Multi-GPU streaming over a 2-D ("image", "unit") mesh of ranks
    (BASELINE.json config 5; default ``image_unit_mesh(2)``): frames are
    grouped into batches of the mesh's image-axis size and each batch is
    inspected with both axes sharded
    (:func:`tpu_inspect_torch.parallel.mesh.inspect_image_batch_sharded`:
    every rank is given the same frames and uploads only its own). A ragged
    final batch is padded by repeating the last frame; padding results are
    dropped. Every rank yields the same results.
    """
    from tpu_inspect_torch.parallel.mesh import image_unit_mesh, inspect_image_batch_sharded

    mesh = mesh or image_unit_mesh(2)
    batch = int(mesh.shape["image"])

    def flush(frames: list[np.ndarray], start: int) -> Iterator[StreamResult]:
        n = len(frames)
        padded = frames + [frames[-1]] * (batch - n)
        verdicts, areas, found, masks, dmasks = inspect_image_batch_sharded(
            np.stack(padded), grid, seg, defect, exclusions=exclusions,
            ref_centroids=ref_centroids, mesh=mesh,
        )
        for j in range(n):
            yield StreamResult(
                index=start + j,
                verdicts=verdicts[j],
                areas=areas[j],
                valid=found[j],
                ng_count=int(verdicts[j].sum()),
                seg_masks=masks[j] if fetch_masks else None,
                defect_masks=dmasks[j] if fetch_masks else None,
            )

    pending: list[np.ndarray] = []
    start = 0
    for image in images:
        pending.append(np.asarray(image))
        if len(pending) == batch:
            yield from flush(pending, start)
            start += batch
            pending = []
    if pending:
        yield from flush(pending, start)
