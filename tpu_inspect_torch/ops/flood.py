"""Kernel D — seeded flood propagation (reachability through a domain).

Port of :func:`tpu_inspect.ops.flood_pallas.propagate_pallas`: the pixels of
``domain`` reachable from ``seed & domain`` through ``domain``, 4- or
8-connected, per unit of a [U, H, W] batch. With ``border_seed`` the seed is
the domain on the image border, made inside the kernel (the exterior flood
of hole filling and of the contour analysis).

Callers: Canny hysteresis (8-connected, seeded by the strong edges) and
:func:`tpu_inspect_torch.ops.hole_fill.exterior_background` (4-connected,
border form).

:func:`propagate` launches ``csrc/flood.cu`` for CUDA tensors and runs
:func:`propagate_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.kernels import Kernel, as_planes, build, error_flag
from tpu_inspect_torch.ops.cc import BIG, propagate_min

_PROPAGATE = Kernel("propagate")


def _border(shape, device) -> torch.Tensor:
    border = torch.zeros(shape, dtype=torch.bool, device=device)
    border[..., 0, :] = True
    border[..., -1, :] = True
    border[..., :, 0] = True
    border[..., :, -1] = True
    return border


def propagate_plain(seed, domain, conn8: bool, border_seed: bool = False):
    """The plain PyTorch version of :func:`propagate` (same contract): the
    min-label fixpoint of ``ops.cc.propagate_min`` with the seed at 0."""
    dom = domain != 0
    s = _border(dom.shape, dom.device) if border_seed else seed != 0
    init = torch.where(dom, torch.where(s, 0, 1), BIG).to(torch.int64)
    return propagate_min(init, dom, conn8=bool(conn8)) == 0


@_PROPAGATE
def propagate(seed, domain, conn8: bool, border_seed: bool = False, err=None):
    """Reachability of ``seed & domain`` through ``domain``.

    ``seed`` and ``domain`` are contiguous [U, H, W] uint8 (or bool) planes,
    nonzero = set; ``seed`` is ignored (may be None) with ``border_seed``.
    Returns [U, H, W] bool. ``err`` (CUDA only): a
    :func:`tpu_inspect_torch.kernels.error_flag` the kernel sets if a
    union-find loop passes its bound, read by the caller where it copies
    results out; without one the wrapper reads its own right after the
    launch."""
    domain = as_planes(domain, "propagate domain")
    if not border_seed:
        seed = as_planes(seed, "propagate seed")
        if seed.shape != domain.shape or seed.device != domain.device:
            raise ValueError("propagate: seed must match domain in shape and device")
    if domain.device.type == "cpu":
        return propagate_plain(seed, domain, conn8, border_seed)
    u, h, w = domain.shape
    if u * h * w >= 2**31:
        raise ValueError(f"propagate: {u}x{h}x{w} too large for int32 indices")
    dev = domain.device
    n = u * h * w
    out = torch.empty((u, h, w), dtype=torch.uint8, device=dev)
    # parents and seed flags are written at run starts only; no zeroing
    parent = torch.empty((n,), dtype=torch.int32, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    bits = torch.empty((u * h * ((w + 31) // 32),), dtype=torch.int32, device=dev)
    flag = error_flag(dev) if err is None else err
    code = build.lib().tik_propagate(
        None if border_seed else seed.data_ptr(), domain.data_ptr(), out.data_ptr(),
        parent.data_ptr(), flags.data_ptr(), bits.data_ptr(), flag.data_ptr(), u, h, w,
        int(bool(conn8)), int(bool(border_seed)), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("propagate", code)
    _PROPAGATE.launched()
    if err is None:
        build.check_bounded("propagate", flag)
    return out.view(torch.bool)
