"""Device milliseconds a frame outside the port's hand kernels: in the
device slice, the time of every operation (PyTorch's kernels, copies and
sets) that is not a ``__global__`` function of the port's CUDA sources
(``tpu_inspect_torch/csrc/*.cu``, ``*.cuh``, whose names are read from the
files, so a renamed kernel is not counted as glue; a kernel of PyTorch's
``at::`` namespaces is glue whatever its name), over the slice's
frames."""

import re
from pathlib import Path

from benchmark.trace import op_name

CSRC = Path(__file__).resolve().parents[2] / "tpu_inspect_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def hand_kernels(csrc: Path = CSRC) -> set[str]:
    """The names of the ``__global__`` functions in the CUDA sources."""
    return {m for f in sorted(csrc.glob("*.cu*")) for m in _GLOBAL.findall(f.read_text())}


def read(run):
    s = run.slices.get("device")
    if not s or not s.device or s.frames <= 0:
        return None
    hand = hand_kernels()
    glue_us = sum(d for n, _, d in s.device if "at::" in n or op_name(n) not in hand)
    return 1e-3 * glue_us / s.frames
