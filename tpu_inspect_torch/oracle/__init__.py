"""OpenCV/numpy oracle: the bit-exact ground truth for the port's engine.

A copy of :mod:`tpu_inspect.oracle` that imports nothing of the JAX
package.

The reference tool delegates all pixel math to OpenCV C++ through cv2; this
package re-states that exact chain as pure, Qt-free functions over numpy
arrays. It serves three roles:

1. the parity oracle every device op and pipeline is tested against,
2. the single-core CPU baseline the benchmarks compare to,
3. executable documentation of the reference's observable semantics.
"""

from tpu_inspect_torch.oracle.reference import (
    apply_exclusions,
    bgr_to_gray,
    detect_defects,
    fill_holes,
    inspect_units,
    largest_component_centroid,
    mask_stats,
    segment_all_units,
    segment_unit,
)

__all__ = [
    "apply_exclusions",
    "bgr_to_gray",
    "detect_defects",
    "fill_holes",
    "inspect_units",
    "largest_component_centroid",
    "mask_stats",
    "segment_all_units",
    "segment_unit",
]
