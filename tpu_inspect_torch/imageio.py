"""Image decode and the crop gather (the port of :mod:`tpu_inspect.imageio`).

Decode parity with the reference's robust loader (ImageWidget.load_image,
indexing_ui.py:145-194): PNG and TIFF decode through the port's native
libpng/libtiff library (:mod:`tpu_inspect_torch.native`) first, and cv2
(imported inside the decode functions only, as the JAX package's fallback
is) takes what it declines; uint16 inputs scale /256, other non-uint8
inputs are min-max normalized, and BGR(A) converts to gray with OpenCV's
fixed-point weights (:mod:`ops.color`).

The crop gather replaces the per-unit ``QImage.copy`` host loop
(indexing_ui.py:2270): all unit origins go to the device as one [U, 2]
tensor and one gather produces the [U, h, w] crop batch there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inspect_torch import native
from tpu_inspect_torch.device import resolve_device
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.ops.color import bgr_to_gray


def load_gray(path: str) -> np.ndarray:
    """Decode an image file to uint8 grayscale (reference loader semantics:
    uint16 /256, float min-max normalized, BGR(A) to gray). The native
    decoder first; cv2 for what it declines."""
    img = native.decode(path)
    if img is None:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError(f"Unable to load image: {path}")
    return _to_gray_u8(img)


def load_gray_stream(paths, capacity: int = 4, threads: int = 3):
    """Iterate uint8 grayscale frames for a list of image paths.

    Same per-frame semantics as :func:`load_gray`, but decode runs ahead on
    the native worker pool (:class:`tpu_inspect_torch.native.StreamLoader`)
    so host decode overlaps device compute in streaming deployments. Frames
    the native decoder declines fall back to :func:`load_gray` one by one;
    unreadable files raise at their position in the stream.
    """
    paths = [str(p) for p in paths]
    for path, raw in zip(paths, native.StreamLoader(paths, capacity, threads)):
        yield _to_gray_u8(raw) if raw is not None else load_gray(path)


def decode_gray(data: bytes) -> np.ndarray:
    """load_gray for in-memory encoded bytes (drag-and-drop uploads,
    indexing_ui.py:1134-1161)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise RuntimeError("Unable to decode image data")
    return _to_gray_u8(img)


def _to_gray_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint16:
        img = (img / 256).astype(np.uint8)
    elif img.dtype != np.uint8:
        import cv2

        img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    if img.ndim == 3:
        if img.shape[2] == 4:
            img = img[:, :, :3]
        img = bgr_to_gray(torch.from_numpy(np.ascontiguousarray(img))).numpy()
    return img


def gather_crops(
    image: torch.Tensor, origins: torch.Tensor, unit_hw: tuple[int, int]
) -> torch.Tensor:
    """image [H, W] uint8 + origins [U, 2] (x, y) -> crops [U, h, w] uint8.

    Start indices follow ``jax.lax.dynamic_slice`` exactly: a negative
    index counts from the end (dim is added), then it is clamped into
    [0, dim - size]. The reference's grids always lie inside the image, so
    this only decides malformed grids. One advanced-indexing gather on the
    image's device.
    """
    h, w = unit_hw
    big_h, big_w = image.shape
    if h > big_h or w > big_w:
        raise ValueError(f"unit {unit_hw} larger than image {tuple(image.shape)}")
    org = origins.to(device=image.device, dtype=torch.int64)
    x0 = torch.where(org[:, 0] < 0, org[:, 0] + big_w, org[:, 0]).clamp(0, big_w - w)
    y0 = torch.where(org[:, 1] < 0, org[:, 1] + big_h, org[:, 1]).clamp(0, big_h - h)
    rows = y0[:, None] + torch.arange(h, device=image.device)[None, :]
    cols = x0[:, None] + torch.arange(w, device=image.device)[None, :]
    return image[rows[:, :, None], cols[:, None, :]].contiguous()


def crops_for_grid(image, grid, device: str | torch.device = "cuda") -> torch.Tensor:
    """Gather all grid-unit crops of a grayscale image (a numpy array or a
    uint8 tensor) on ``device``: [U, h, w] uint8."""
    dev = resolve_device(device)
    if isinstance(image, torch.Tensor):
        image_t = image.to(device=dev, dtype=torch.uint8)
    else:
        image_t = torch.from_numpy(np.ascontiguousarray(image, dtype=np.uint8)).to(dev)
    origins = torch.from_numpy(grid_origins(grid)).to(dev)
    _, _, w, h = grid.base_unit
    return gather_crops(image_t, origins, (int(h), int(w)))
