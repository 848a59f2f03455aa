"""The system under test: the one-capture program of ``tpu_inspect_torch``.

The only module of the benchmark that imports the port. A frame is
dispatched as the port's ``streaming.stream_inspect`` dispatches one:
``engine._inspect_image_device`` on the capture with a bound flag of its
own, nothing waited for. Its flag, verdicts, areas and found flags are then
copied into pinned host buffers behind the frame's work, and an event
recorded after the copies says when they have arrived: its device time
is the time the answers are in host memory.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Flight:
    """One dispatched frame: its host buffers, their event, and the device
    tensors of its masks and shifts (kept for the comparison)."""

    index: int
    pool: int
    host: tuple
    event: torch.cuda.Event | None
    device: tuple = field(repr=False, default=())

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class Program:
    """The port's program for configuration ``cfg`` on ``device``."""

    def __init__(self, cfg: dict, device: torch.device):
        from tpu_inspect_torch import engine
        from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
        from tpu_inspect_torch.geometry import grid_origins
        from tpu_inspect_torch.kernels import error_flag

        # the port's chained route (kernel K for a reference-aligned otsu
        # frame) is opt-in; the engine reads the flag at each call, so it is
        # set here whatever imported the engine first
        engine._ENABLE_CHAIN = bool(cfg.get("chained_reference_capture", False))
        self.engine, self.error_flag = engine, error_flag
        g = cfg["grid"]
        self.grid = GridParams(base_unit=tuple(g["base_unit"]), **{
            k: v for k, v in g.items() if k != "base_unit"})
        self.seg = SegmentationParams(**cfg["segmentation"]).validated()
        self.defect = DefectParams(**cfg["defect"]).validated()
        self.exclusions = [dict(e) for e in cfg["exclusions"]]
        self.device = device
        self.origins = torch.from_numpy(grid_origins(self.grid)).to(device)
        _, _, w, h = self.grid.base_unit
        self.unit_hw = (int(h), int(w))
        self.anchors = None
        self._free: list[tuple] = []

    def set_reference(self, image: torch.Tensor) -> None:
        """Take the reference capture's centroids as the anchors of every
        later frame (the tool's run_segmentation_all on the reference
        image): from then on each frame runs the exclusion alignment."""
        seg, _ = self.engine.inspect_image(image, self.grid, self.seg, None, self.exclusions,
                                           is_reference=True, device=self.device)
        self.anchors = seg.centroid_dict()

    def _buffers(self, outs) -> tuple:
        if self._free:
            return self._free.pop()
        pin = self.device.type == "cuda"
        return tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for t in outs)

    def dispatch(self, index: int, pool: int, image: torch.Tensor) -> Flight:
        """Enqueue frame ``index`` (the pool's capture ``pool``) and the copy
        of its answers; returns without waiting for the card."""
        err = self.error_flag(self.device)
        masks, _, _, shifts, (dmasks, found, area, verdict) = self.engine._inspect_image_device(
            image, self.origins, self.unit_hw, self.seg, self.defect, self.exclusions,
            self.anchors, self.anchors is None, True, err)
        outs = (err, verdict, area, found)
        host = self._buffers(outs)
        for dst, src in zip(host, outs):
            dst.copy_(src, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return Flight(index, pool, host, event, (masks, shifts, dmasks))

    def answers(self, f: Flight) -> tuple:
        """A finished frame's (flag, verdicts, areas, found) as numpy arrays;
        its host buffers go back to the free list."""
        out = tuple(t.numpy().copy() for t in f.host)
        self._free.append(f.host)
        return out
