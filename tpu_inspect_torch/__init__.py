"""tpu-inspect on PyTorch + CUDA: the inspection engine ported to one
NVIDIA H100.

The JAX/Pallas package :mod:`tpu_inspect` stays the reference; this package
reproduces it bit-exactly with torch ops plus sixteen CUDA C++ kernels
written for Hopper (``csrc/``, kernels A-L and the head kernels: Otsu, M
the u8 Gaussian blur, N the adaptive mean, O Canny's gradient and
non-maximum suppression): the inspection paths
(:func:`tpu_inspect_torch.engine.inspect_image` with the otsu/adaptive
segmentation and threshold/canny defect methods, the chained seg+ROI tail,
the whole-image route, ``defect_intermediates``), the session and UI
server, the capture stream (:mod:`tpu_inspect_torch.streaming`), the
sharded paths on ``torch.distributed`` (:mod:`tpu_inspect_torch.parallel`), the CLI
(``python -m tpu_inspect_torch.cli``), the native libpng/libtiff loader
(:mod:`tpu_inspect_torch.native`) and the median-probe tool. It imports
neither jax nor :mod:`tpu_inspect`; the host-only helpers it needs are
copies.

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
    if name in ("stream_inspect", "stream_inspect_paths"):
        from tpu_inspect_torch import streaming

        return getattr(streaming, name)
    if name == "InspectionSession":
        from tpu_inspect_torch.session import InspectionSession

        return InspectionSession
    if name == "load_grid":
        from tpu_inspect_torch.persistence import load_grid

        return load_grid
    raise AttributeError(name)


__all__ = [
    "DefectParams",
    "GridParams",
    "InspectionParams",
    "InspectionSession",
    "SegmentationParams",
    "defect_intermediates",
    "detect_defects_batch",
    "grid_boxes",
    "inspect_image",
    "inspect_units",
    "load_grid",
    "segment_units",
    "stream_inspect",
    "stream_inspect_paths",
]
