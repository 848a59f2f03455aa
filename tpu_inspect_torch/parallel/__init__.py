"""Multi-GPU data parallelism: rank meshes and sharded inspection on
``torch.distributed``.

The port of :mod:`tpu_inspect.parallel`: the same public names, re-exported
from :mod:`tpu_inspect_torch.parallel.mesh` and
:mod:`tpu_inspect_torch.parallel.strips` (the sharded streaming loop lives
in :func:`tpu_inspect_torch.streaming.stream_inspect_sharded`; the ranks,
their collectives and the launcher in :mod:`tpu_inspect_torch.parallel.launch`).
"""

from tpu_inspect_torch.parallel.mesh import (
    image_unit_mesh,
    inspect_image_batch_sharded,
    inspect_units_sharded,
    pad_units,
    unit_mesh,
)
from tpu_inspect_torch.parallel.strips import (
    defect_image_sharded,
    segment_image_sharded,
    strip_mesh,
)

__all__ = [
    "defect_image_sharded",
    "image_unit_mesh",
    "inspect_image_batch_sharded",
    "inspect_units_sharded",
    "pad_units",
    "segment_image_sharded",
    "strip_mesh",
    "unit_mesh",
]
