"""tpu-inspect on PyTorch + CUDA: the inspection engine ported to one
NVIDIA H100.

The JAX/Pallas package :mod:`tpu_inspect` stays the reference; this package
reproduces its inspection path (:func:`tpu_inspect_torch.engine.inspect_image`
with the otsu/adaptive segmentation and threshold/canny defect methods, and
``defect_intermediates``) bit-exactly with torch ops plus five CUDA C++
kernels written for Hopper (``csrc/``): the segmentation/ROI tail, the
median residual, the blob filter, seeded flood propagation and min-index
labeling. It imports neither jax nor :mod:`tpu_inspect`; the host-only helpers
it needs are numpy copies (``config``, ``geometry``, ``synthetic``,
``ops/_contour_table``).

Public entry points take an explicit ``device`` ("cuda" by default, which
raises when no GPU is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels).
"""

__version__ = "0.1.0"

from tpu_inspect_torch.config import (  # noqa: E402
    DefectParams,
    GridParams,
    InspectionParams,
    SegmentationParams,
)
from tpu_inspect_torch.geometry import grid_boxes  # noqa: E402


def __getattr__(name):
    # lazy engine API: importing the package builds no kernel
    if name in ("inspect_image", "inspect_units", "segment_units",
                "detect_defects_batch", "defect_intermediates"):
        from tpu_inspect_torch import engine

        return getattr(engine, name)
    raise AttributeError(name)


__all__ = [
    "DefectParams",
    "GridParams",
    "InspectionParams",
    "SegmentationParams",
    "defect_intermediates",
    "detect_defects_batch",
    "grid_boxes",
    "inspect_image",
    "inspect_units",
    "segment_units",
]
