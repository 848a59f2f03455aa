"""Unit-batch and image-batch data parallelism over ranks.

The port of :mod:`tpu_inspect.parallel.mesh`. Every per-unit stage is
independent, so sharding the unit batch across ranks is pure data
parallelism: each rank runs the engine's split path
(:func:`tpu_inspect_torch.engine._segment` then
:func:`tpu_inspect_torch.engine._defect`: on the card the Otsu kernel, then
kernels A, B and C) on its own unit slice, and only the outputs are
gathered at the end. A 2-D ("image", "unit") mesh shards a batch of
captures both ways: each rank uploads its own image, gathers its unit
slice's crops from it and inspects them.

Both paths run the real workflow: exclusion zones and per-unit
centroid-alignment shifts. The anchors are laid out over the global unit
index first and then sliced, so every rank aligns its units against their
own anchors. Units are padded to a multiple of the unit axis (equal shards
are what ``all_gather`` takes); padded units are zero crops (origin (0, 0)
on the image x unit mesh) and are cut off before anything returns.

Every rank calls these with the same host arguments and gets the same full
host results, which equal the single-device engine's
(:func:`tpu_inspect_torch.engine.inspect_units`, with areas as int64).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inspect_torch import engine
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.kernels import build, error_flag
from tpu_inspect_torch.parallel.launch import Mesh, all_gather_rows, group_size, make_mesh


def unit_mesh(group=None, device=None) -> Mesh:
    """1-D mesh over the ranks of ``group`` (the default process group; one
    rank without one); axis 'unit' shards the unit batch. ``device``: this
    rank's (default :func:`tpu_inspect_torch.parallel.launch.rank_device`)."""
    return make_mesh(("unit",), (-1,), group, device)


def image_unit_mesh(n_images: int, group=None, device=None) -> Mesh:
    """2-D ("image", "unit") mesh: ``n_images`` rows of ranks, units sharded
    within each row. For multi-image streaming (BASELINE.json config 5)."""
    n = group_size(group)
    if n % n_images:
        raise ValueError(f"{n} ranks not divisible by {n_images} images")
    return make_mesh(("image", "unit"), (n_images, n // n_images), group, device)


def pad_units(n: int, n_shards: int) -> int:
    """Units are padded to a multiple of the mesh size (padded units are
    all-background crops and produce OK verdicts that callers slice off)."""
    return (n + n_shards - 1) // n_shards * n_shards


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` with zero rows appended up to ``n`` rows."""
    if a.shape[0] == n:
        return a
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])


def _anchors(ref_arr: np.ndarray, ref_ok: np.ndarray) -> dict[int, tuple[float, float]]:
    """One shard's anchors as the engine's dict, keyed by the shard's own
    unit index."""
    return {i: (float(a[0]), float(a[1])) for i, (a, ok) in enumerate(zip(ref_arr, ref_ok)) if ok}


def _inspect_shard(crops, seg, defect, exclusions, ref_arr, ref_ok, is_reference, name):
    """The per-rank body: the engine's seg then defect pass on this rank's
    [u, H, W] crops, one bound flag read before it returns -> (planes [u, 2,
    H, W] uint8: masks, defect masks; columns [u, 9] int64: sx, sy, area,
    has_fg, dx, dy, found, defect area, verdict)."""
    err = error_flag(crops.device)
    masks, sums, has_fg, shifts = engine._segment(
        crops, seg, exclusions, _anchors(ref_arr, ref_ok), is_reference, err
    )
    dmasks, found, area, verdict = engine._defect(crops, masks, defect, err)
    build.check_bounded(name, err)
    cols = torch.cat([sums, has_fg[:, None], shifts, found[:, None], area[:, None],
                      verdict[:, None]], dim=1).to(torch.int64)
    return torch.stack([masks, dmasks], dim=1), cols


def _unit_slice(mesh: Mesh, n_pad: int) -> slice:
    k, n_unit = mesh.coord("unit"), mesh.shape["unit"]
    ul = n_pad // n_unit
    return slice(k * ul, (k + 1) * ul)


def inspect_units_sharded(
    crops: np.ndarray,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids=None,
    is_reference: bool = True,
    mesh: Mesh | None = None,
) -> tuple[engine.SegmentationResult, engine.InspectionResult]:
    """Inspect a [U, H, W] uint8 unit batch sharded across the ranks of
    ``mesh`` (default :func:`unit_mesh`) — the full workflow (exclusion
    zones and centroid-alignment shifts included), matching
    :func:`tpu_inspect_torch.engine.inspect_units` with the unit axis
    distributed. On a 2-D mesh the units are sharded over its 'unit' axis.

    Returns (SegmentationResult, InspectionResult) as host arrays with
    padding stripped (areas int64), the same on every rank.
    """
    seg = (seg or SegmentationParams()).validated()
    defect = (defect or DefectParams()).validated()
    mesh = mesh or unit_mesh()
    n_unit = mesh.shape["unit"]
    crops = np.asarray(crops)
    n = crops.shape[0]
    n_pad = pad_units(n, n_unit)
    ref_arr, ref_ok = engine.ref_centroid_arrays(ref_centroids, n)
    mine = _unit_slice(mesh, n_pad)
    local = engine._as_u8(_pad(crops, n_pad)[mine], mesh.device)
    planes, cols = _inspect_shard(
        local, seg, defect, exclusions, _pad(ref_arr, n_pad)[mine], _pad(ref_ok, n_pad)[mine],
        bool(is_reference), "inspect_units_sharded",
    )
    # all ranks' shards in mesh order; a 2-D mesh repeats the unit shards
    # once per image row: keep the first
    planes = all_gather_rows(planes, mesh)[:n_pad].cpu().numpy()[:n]
    cols = all_gather_rows(cols, mesh)[:n_pad].cpu().numpy()[:n]
    seg_res = engine.SegmentationResult(
        masks=np.ascontiguousarray(planes[:, 0]),
        centroids=engine.centroids_from_sums(cols[:, 0:3]),
        centroid_valid=cols[:, 3].astype(bool),
        shifts=cols[:, 4:6].astype(np.int32),
    )
    insp = engine.InspectionResult(
        defect_masks=np.ascontiguousarray(planes[:, 1]),
        valid=cols[:, 6].astype(bool),
        areas=cols[:, 7].astype(np.int64),
        verdicts=cols[:, 8].astype(bool),
    )
    return seg_res, insp


def inspect_image_batch_sharded(
    images: np.ndarray,
    grid: GridParams,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids=None,
    mesh: Mesh | None = None,
):
    """Inspect a [B, H, W] batch of full images over a 2-D ("image",
    "unit") mesh (default ``image_unit_mesh(B)``; B must equal its image
    axis): each rank uploads only its own image, gathers its unit slice's
    crops from it and inspects them, so all B*U units are jointly
    data-parallel across the mesh.

    ``ref_centroids`` anchors apply per unit (shared across images, as every
    streamed frame aligns against the same reference capture). Returns
    (verdicts [B,U] bool, areas [B,U] int64, valid [B,U] bool,
    seg_masks [B,U,h,w], defect_masks [B,U,h,w]), the same on every rank.
    """
    seg = (seg or SegmentationParams()).validated()
    defect = (defect or DefectParams()).validated()
    images = np.asarray(images)
    mesh = mesh or image_unit_mesh(images.shape[0])
    n_img, n_unit = mesh.shape["image"], mesh.shape["unit"]
    if images.shape[0] != n_img:
        raise ValueError(f"{images.shape[0]} images for a mesh of {n_img} image rows")
    origins = np.asarray(grid_origins(grid))
    u = origins.shape[0]
    upad = pad_units(u, n_unit)
    _, _, w, h = grid.base_unit
    ref_arr, ref_ok = engine.ref_centroid_arrays(ref_centroids, u)
    mine = _unit_slice(mesh, upad)
    image = engine._as_u8(images[mesh.coord("image")], mesh.device)
    crops = gather_crops(image, torch.from_numpy(_pad(origins, upad)[mine]).to(mesh.device),
                         (int(h), int(w)))
    planes, cols = _inspect_shard(
        crops, seg, defect, exclusions, _pad(ref_arr, upad)[mine], _pad(ref_ok, upad)[mine],
        ref_centroids is None, "inspect_image_batch_sharded",
    )
    planes = all_gather_rows(planes, mesh).cpu().numpy().reshape((n_img, upad) + planes.shape[1:])
    cols = all_gather_rows(cols, mesh).cpu().numpy().reshape(n_img, upad, -1)
    return (
        cols[:, :u, 8].astype(bool),
        cols[:, :u, 7].astype(np.int64),
        cols[:, :u, 6].astype(bool),
        np.ascontiguousarray(planes[:, :u, 0]),
        np.ascontiguousarray(planes[:, :u, 1]),
    )
