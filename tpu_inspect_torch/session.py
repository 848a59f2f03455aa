"""Multi-image inspection session (headless reference-workflow parity).

Mirrors the reference tool's multi-image state machine
(indexing_ui.py:570-584, :1016-1292) without Qt:

- the first registered image becomes the *reference*; exclusions and
  indexing are editable only while it is current (:1233-1255, :1764-1777),
- per-image results (segmentation masks, defect masks, verdicts) are cached
  and restored on switches (:1016-1085),
- switching to an image of a different size while a grid exists is refused
  (:1212-1222),
- switching auto-reruns segmentation so exclusions re-align via centroid
  shift (:1276-1290), and re-runs inspection when the toggle is on.

The session is array-based: "paths" may be real files (decoded through
tpu_inspect_torch.imageio) or arbitrary keys registered with in-memory
arrays.

The port of :mod:`tpu_inspect.session`: every pass goes through
:mod:`tpu_inspect_torch.engine` on ``device`` ("cuda" unless the caller
asks for the CPU), and the crop batch stays cached on that device. Engine
results are stored read-only, as the JAX package's device-fetched arrays
are, so a single-unit update copies them first and never changes a result
object a caller already holds.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from tpu_inspect_torch import engine
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import (
    BoxGrid,
    clamp_exclusion_to_base_unit,
    grid_boxes,
)
from tpu_inspect_torch.persistence import (
    GridDocument,
    export_masks_and_csv,
    grid_metadata,
    load_grid,
    save_grid,
)
from tpu_inspect_torch.utils.logging import InspectionLog


class SessionError(RuntimeError):
    pass


def _read_only(result):
    """Mark an engine result's arrays read-only (in place) and return it."""
    for f in fields(result):
        getattr(result, f.name).setflags(write=False)
    return result


@dataclass
class ImageState:
    """Cached per-image results (the _image_states equivalent)."""

    seg: engine.SegmentationResult | None = None
    insp: engine.InspectionResult | None = None


@dataclass
class InspectionSession:
    seg_params: SegmentationParams = SegmentationParams()
    defect_params: DefectParams = DefectParams()
    grid: GridParams | BoxGrid | None = None
    exclusions: list[dict] = field(default_factory=list)
    ref_centroids: dict[int, tuple[float, float]] = field(default_factory=dict)
    inspection_enabled: bool = False
    # overlay rendering mode, default 'Defect' (indexing_ui.py:877-879)
    overlay_mode: str = "Defect"
    log: InspectionLog = field(default_factory=InspectionLog)
    device: str | torch.device = "cuda"

    _images: dict[str, np.ndarray] = field(default_factory=dict)
    _order: list[str] = field(default_factory=list)
    _states: dict[str, ImageState] = field(default_factory=dict)
    reference_path: str | None = None
    current_path: str | None = None

    # -- image registry -----------------------------------------------------

    def add_image(self, path: str, image: np.ndarray | None = None) -> None:
        """Register an image (decoded from disk when no array is given).

        The first image becomes the reference (indexing_ui.py:1196-1208).
        """
        if image is None:
            from tpu_inspect_torch.imageio import load_gray

            image = load_gray(path)
        image = np.asarray(image, dtype=np.uint8)
        if path not in self._images:
            self._order.append(path)
        self._images[path] = image
        self._states.setdefault(path, ImageState())
        if self.reference_path is None:
            self.reference_path = path
        if self.current_path is None:
            self.switch_to(path)

    @property
    def image(self) -> np.ndarray:
        if self.current_path is None:
            raise SessionError("no image loaded")
        return self._images[self.current_path]

    @property
    def is_reference(self) -> bool:
        return (
            self.reference_path is None
            or self.current_path == self.reference_path
        )

    def switch_to(self, path: str) -> None:
        """Switch current image; blocks size mismatches when a grid exists
        and re-runs segmentation/inspection (indexing_ui.py:1184-1292)."""
        if path not in self._images:
            raise SessionError(f"unknown image: {path}")
        if self.grid is not None and self.current_path is not None:
            if self._images[path].shape != self.image.shape:
                raise SessionError(
                    "image size mismatch: clear indexing before switching "
                    "(reference behavior indexing_ui.py:1212-1222)"
                )
        self.current_path = path
        if self.grid is not None:
            self.run_segmentation()
            if self.inspection_enabled:
                self.run_inspection()

    # -- indexing / exclusions ----------------------------------------------

    def _require_reference(self, what: str) -> None:
        if not self.is_reference:
            raise SessionError(
                f"{what} is locked to the reference image "
                "(indexing_ui.py:1764-1777, :1233-1255)"
            )

    def apply_indexing(self, grid: GridParams) -> int:
        self._require_reference("indexing")
        self.grid = grid
        self.ref_centroids = {}  # anchors invalid (indexing_ui.py:2197-2200)
        return grid.num_units

    def add_exclusion(self, excl: dict) -> int:
        """Add (clamped) exclusion and re-run segmentation; returns its index."""
        self._require_reference("exclusion editing")
        if self.grid is None:
            raise SessionError("create indexing first")
        _, _, bw, bh = self.grid.base_unit
        self.exclusions.append(clamp_exclusion_to_base_unit(excl, bw, bh))
        self.run_segmentation()
        return len(self.exclusions) - 1

    def modify_exclusion(self, idx: int, excl: dict) -> None:
        self._require_reference("exclusion editing")
        _, _, bw, bh = self.grid.base_unit
        self.exclusions[idx] = clamp_exclusion_to_base_unit(excl, bw, bh)
        self.run_segmentation()

    def delete_exclusion(self, idx: int) -> None:
        self._require_reference("exclusion editing")
        del self.exclusions[idx]
        self.run_segmentation()

    # -- parameter edits (exit inspection, indexing_ui.py:1305-1316) ---------

    def set_seg_params(self, params: SegmentationParams) -> None:
        """Any parameter change exits inspection mode back to overlays
        (indexing_ui.py:1305-1316); the client debounces the re-run."""
        self.exit_inspection()
        self.seg_params = params

    def set_defect_params(self, params: DefectParams) -> None:
        self.exit_inspection()
        self.defect_params = params

    def exit_inspection(self, force_overlay_mode: str = "Both") -> None:
        """Leave inspection mode and restore overlay rendering
        (indexing_ui.py:1341-1360)."""
        self.inspection_enabled = False
        if force_overlay_mode:
            self.overlay_mode = force_overlay_mode

    # -- passes --------------------------------------------------------------

    def _crops(self):
        """Device-resident [U, h, w] crop batch for the current image+grid,
        cached (the defect passes consume it directly on device — no
        host round-trip per inspection/test)."""
        from tpu_inspect_torch.imageio import crops_for_grid

        key = (self.current_path, self.grid)
        cached = getattr(self, "_crop_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        crops = crops_for_grid(self.image, self.grid, self.device)
        self._crop_cache = (key, crops)
        return crops

    def run_segmentation(self) -> engine.SegmentationResult:
        if self.grid is None:
            raise SessionError("no grid available")
        # switches the overlay to Segmentation (indexing_ui.py:2207-2212)
        self.overlay_mode = "Segmentation"
        seg_res, _ = engine.inspect_image(
            self.image,
            self.grid,
            self.seg_params,
            defect=None,
            exclusions=self.exclusions,
            ref_centroids=None if self.is_reference else self.ref_centroids,
            is_reference=self.is_reference,
            device=self.device,
        )
        _read_only(seg_res)
        if self.is_reference:
            # fresh reference run resets anchors (indexing_ui.py:2258-2265)
            self.ref_centroids = seg_res.centroid_dict()
        self._states[self.current_path].seg = seg_res
        return seg_res

    def run_inspection(self) -> engine.InspectionResult:
        """Defect pass + verdicts over the EXISTING segmentation masks;
        segmentation is auto-run only when missing (indexing_ui.py:1641-1662
        — the reference inspects with whatever masks are stored, even if seg
        parameters changed since they were computed)."""
        state = self._states[self.current_path]
        if state.seg is None:
            self.run_segmentation()
            state = self._states[self.current_path]
        insp = _read_only(engine.detect_defects_batch(
            self._crops(), state.seg.masks, self.defect_params, device=self.device
        ))
        state.insp = insp
        self.log.inspection_summary(
            int(insp.verdicts.sum()), int(insp.verdicts.shape[0])
        )
        return insp

    def set_inspection(self, enabled: bool) -> engine.InspectionResult | None:
        """Inspection toggle (indexing_ui.py:1361-1373): ON computes and
        shows X/O; OFF exits back to overlays."""
        if enabled:
            self.inspection_enabled = True
            return self.run_inspection()
        self.exit_inspection()
        return None

    # -- single-unit defect tuning (indexing_ui.py:1411-1469, :1305-1339) ----

    def _ensure_insp_arrays(self, state: ImageState) -> engine.InspectionResult:
        if state.insp is None:
            u, h, w = state.seg.masks.shape
            state.insp = engine.InspectionResult(
                defect_masks=np.zeros((u, h, w), dtype=np.uint8),
                valid=np.zeros((u,), dtype=bool),
                areas=np.zeros((u,), dtype=np.int64),
                verdicts=np.zeros((u,), dtype=bool),
            )
        elif not state.insp.defect_masks.flags.writeable:
            # engine results are stored read-only; copy before single-unit
            # in-place updates
            state.insp = engine.InspectionResult(
                defect_masks=state.insp.defect_masks.copy(),
                valid=state.insp.valid.copy(),
                areas=state.insp.areas.copy(),
                verdicts=state.insp.verdicts.copy(),
            )
        return state.insp

    def _detect_one(self, idx: int) -> tuple[np.ndarray | None, int]:
        state = self._states[self.current_path]
        if state.seg is None:
            raise SessionError(
                "no segmentation mask for this unit — run segmentation first"
            )
        crops = self._crops()
        if not (0 <= idx < crops.shape[0]):
            raise SessionError(f"unit index out of range: {idx}")
        one = engine.detect_defects_batch(
            crops[idx : idx + 1],
            state.seg.masks[idx : idx + 1],
            self.defect_params,
            device=self.device,
        )
        insp = self._ensure_insp_arrays(state)
        insp.defect_masks[idx] = one.defect_masks[0]
        insp.valid[idx] = one.valid[0]
        insp.areas[idx] = one.areas[0]
        insp.verdicts[idx] = one.verdicts[0]
        mask = one.defect_masks[0] if one.valid[0] else None
        return mask, int(one.areas[0])

    def test_defect_unit(self, idx: int, verbose: bool = True) -> dict:
        """Single-unit "Test Defect Detection" (indexing_ui.py:1411-1469):
        exits inspection mode, shows Both overlays, recomputes the unit's
        defect mask, and logs ``Unit {row}: defect area={area} px -> NG|OK``.

        With ``verbose`` (the reference single-unit default,
        indexing_ui.py:1471), the per-stage diagnostics an operator tunes
        against are logged in the reference's exact formats: seg-ROI area +
        erode_px (:1494), the empty-ROI skip (:1515), the residual mask
        area (:1535), the area-filter bounds (:1549), and each skipped
        too-large contour (:1556).

        Returns {'mask', 'area', 'verdict', 'found'}; the caller zooms via
        viewport.center_on_cell (the reference's center_on_cell :1711-1752).
        """
        self.exit_inspection(force_overlay_mode="Both")
        if verbose:
            self._log_defect_diagnostics(idx)
        mask, area = self._detect_one(idx)
        if mask is None:
            self.log.log("No defects found (or detection failed).")
        # verdict rule matches the engine: a None mask is OK regardless of
        # min_area (indexing_ui.py:1686-1700)
        verdict = mask is not None and area >= int(self.defect_params.min_area)
        self.log.unit_verdict(idx, area, int(self.defect_params.min_area))
        return {
            "mask": mask,
            "area": area,
            "verdict": "NG" if verdict else "OK",
            "found": mask is not None,
        }

    def _log_defect_diagnostics(self, idx: int) -> None:
        """The reference's verbose per-stage debug lines for one unit
        (indexing_ui.py:1494, :1515, :1535, :1549, :1556), computed by the
        engine's diagnostic pass (engine.defect_intermediates)."""
        state = self.results()
        if state.seg is None:
            return
        crops = self._crops()
        d = engine.defect_intermediates(
            crops[idx], state.seg.masks[idx], self.defect_params, device=self.device
        )
        self.log.log(
            f"Seg mask area (roi)={d['seg_area0']}, erode_px={d['erode_px']}"
        )
        if d["roi_empty"]:
            self.log.log(
                "Segmentation mask empty after erode — skipping detection "
                "for this unit"
            )
            return
        if "resid_area" in d:
            self.log.log(f"Residual mask area={d['resid_area']}")
        self.log.log(
            f"Defect area filter: min={d['min_area']}, max={d['max_area']}, "
            f"seg_area={d['roi_area']}"
        )
        for a in d.get("skipped_large", ()):
            self.log.log(
                f"Skipping large contour area={a} (>max={d['max_area']})"
            )

    def auto_update_defect_unit(self, idx: int) -> np.ndarray | None:
        """Debounced live re-run body (indexing_ui.py:1324-1339): silently
        recompute one unit's defect mask after a parameter change. The
        scheduler exits inspection mode first (:1305-1316); call
        set_defect_params (which exits) before this, as a UI client's
        debounce timer does."""
        mask, _ = self._detect_one(idx)
        return mask

    def results(self, path: str | None = None) -> ImageState:
        return self._states[path or self.current_path]

    # -- persistence ---------------------------------------------------------

    def export_grid(self, path=None) -> dict:
        if self.grid is None:
            raise SessionError("no grid to export")
        h, w = self.image.shape
        doc = GridDocument(
            boxes=grid_boxes(self.grid),
            metadata=grid_metadata(self.grid, w, h),
            exclusions=list(self.exclusions),
            ref_centroids=dict(self.ref_centroids),
        )
        return save_grid(doc, path)

    def import_grid(self, path_or_obj) -> int:
        doc = load_grid(path_or_obj)
        params = doc.grid_params
        if params is None:
            raise SessionError("no valid boxes in grid JSON")
        self.grid = params
        self.exclusions = list(doc.exclusions)
        self.ref_centroids = dict(doc.ref_centroids)
        return len(doc.boxes)

    def export_masks(self, dirpath) -> str:
        state = self.results()
        if state.seg is None:
            raise SessionError("run segmentation first")
        return export_masks_and_csv(list(state.seg.masks), dirpath)

    def export_thumbnails(self, dirpath) -> int:
        """Per-unit crop PNGs, ``unit_%04d.png`` (indexing_ui.py:3127-3140).

        Requires an applied grid (the reference guards on an empty thumb
        list with 'Apply indexing first')."""
        from tpu_inspect_torch.persistence import export_thumbnails

        if self.grid is None:
            raise SessionError(
                "no thumbnails to export — apply indexing first"
            )
        crops = self._crops().cpu().numpy()
        return export_thumbnails(list(crops), dirpath)
