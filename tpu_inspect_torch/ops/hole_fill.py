"""Border-flood hole filling, batched [U, H, W].

Port of :mod:`tpu_inspect.ops.hole_fill` (fill_internal_holes,
segmentation.py:27-72): background 4-connected to the image border is
"exterior"; every other background pixel is a hole.
:func:`exterior_background` is kernel D (``ops.flood.propagate``) in its
border-seeded, 4-connected form on CUDA tensors;
:func:`exterior_background_plain` is the min-label fixpoint whose row/column
sweeps cross whole free runs at once (``ops.cc.propagate_min``), so it
converges in O(#bends) iterations.
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.ops.flood import propagate, propagate_plain


def exterior_background_plain(fg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`exterior_background`."""
    return propagate_plain(None, ~fg, conn8=False, border_seed=True)


def exterior_background(fg: torch.Tensor, *, err=None) -> torch.Tensor:
    """Background 4-connected to the border. fg: [U, H, W] bool -> bool.
    ``err`` as for :func:`tpu_inspect_torch.ops.flood.propagate`."""
    return propagate(None, (~fg).contiguous(), conn8=False, border_seed=True, err=err)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """fill_internal_holes parity: uint8 in (any >0 is fg), bool out."""
    fg = mask > 0
    return fg | ~exterior_background(fg)
