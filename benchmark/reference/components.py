"""Connected components of bool planes [U, H, W] in plain PyTorch, and the
region arithmetic of OpenCV's contour and component calls built on them.

A component's label is one plus the lowest flat index (over the whole
batch) of its pixels, so labels never repeat between units and the order
of labels within a unit is the raster order of the components' first
pixels; 0 marks the background. Labels are found by repeated neighbour
minima with pointer jumping, until nothing changes.
"""

from __future__ import annotations

import torch

_N4 = ((-1, 0), (0, -1), (0, 1), (1, 0))
_N8 = _N4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _shifted(p: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def components(mask: torch.Tensor, conn8: bool) -> torch.Tensor:
    """int64 labels of the 8- (or 4-) connected components of ``mask``."""
    u, h, w = mask.shape
    n = u * h * w
    big = n  # above every index; the slot it names holds itself
    lab = torch.where(mask, torch.arange(n, device=mask.device).view(u, h, w), big)
    pad = torch.full((u, h + 2, w + 2), big, dtype=torch.int64, device=mask.device)
    table = torch.empty(n + 1, dtype=torch.int64, device=mask.device)
    table[n] = big
    while True:
        pad[:, 1:-1, 1:-1] = lab
        m = lab
        for dy, dx in _N8 if conn8 else _N4:
            m = torch.minimum(m, _shifted(pad, dy, dx, h, w))
        m = torch.where(mask, m, big)
        table[:n] = m.reshape(-1)
        for _ in range(4):  # follow each pointer to its pointer's pointer
            m = table[m]
            table[:n] = m.reshape(-1)
        if torch.equal(m, lab):
            return torch.where(mask, lab + 1, 0)
        lab = m


def border_labels(labels: torch.Tensor) -> torch.Tensor:
    """[n + 1] bool table: which labels of ``labels`` touch the plane's
    border."""
    n = labels.numel()
    edge = torch.zeros(labels.shape[-2:], dtype=torch.bool, device=labels.device)
    edge[0, :] = edge[-1, :] = True
    edge[:, 0] = edge[:, -1] = True
    table = torch.zeros(n + 1, dtype=torch.bool, device=labels.device)
    table[labels[:, edge].reshape(-1)] = True
    table[0] = False
    return table


def exterior(fg: torch.Tensor) -> torch.Tensor:
    """Background 4-connected to the plane's border (outside the plane is
    background): the pixels a flood fill from the border reaches."""
    lab = components(~fg, conn8=False)
    return border_labels(lab)[lab]


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """The segmentation's hole fill (segmentation.py:27-72): every
    background pixel the border's 4-connected flood fill does not reach
    becomes foreground."""
    return ~exterior(mask)


def largest(mask: torch.Tensor):
    """The largest 8-connected component of each unit, as
    ``cv2.connectedComponentsWithStats`` and ``np.argmax`` of its areas pick
    it (a tie keeps the lower label): (bool plane, area [U] int64,
    sum of x [U] int64, sum of y [U] int64)."""
    u, h, w = mask.shape
    lab = components(mask, conn8=True)
    area = torch.bincount(lab.reshape(-1), minlength=u * h * w + 1)[1:].view(u, h * w)
    best = area.argmax(dim=1)  # the first maximum: the lowest label
    best_area = area.gather(1, best[:, None])[:, 0]
    root = best + torch.arange(u, device=mask.device) * (h * w) + 1
    keep = (lab == root[:, None, None]) & (best_area > 0)[:, None, None]
    ys = torch.arange(h, device=mask.device)[None, :, None]
    xs = torch.arange(w, device=mask.device)[None, None, :]
    sx = torch.where(keep, xs, 0).sum(dim=(1, 2))
    sy = torch.where(keep, ys, 0).sum(dim=(1, 2))
    return keep, best_area, sx, sy


def contour_visits(fill: torch.Tensor) -> torch.Tensor:
    """How often the outer border that ``cv2.findContours`` traces through
    pixel centres (8-connected foreground, 4-connected background) visits
    each pixel of ``fill`` (a union of filled top-level regions): once for
    each circular run of exterior pixels (those not in ``fill``, and
    everything outside the plane) in its 8-neighbourhood that holds one of
    its 4-neighbours. A run of one diagonal neighbour alone is crossed by a
    diagonal step, not visited."""
    u, h, w = fill.shape
    p = torch.ones((u, h + 2, w + 2), dtype=torch.bool, device=fill.device)
    p[:, 1:-1, 1:-1] = ~fill
    ring = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]
    e = [_shifted(p, dy, dx, h, w) for dy, dx in ring]
    runs = torch.zeros((u, h, w), dtype=torch.int64, device=fill.device)
    for i in range(8):
        runs += (e[i] & ~e[i - 1]).to(torch.int64)
        if i % 2:  # a diagonal exterior neighbour between two that are not
            runs -= (e[i] & ~e[i - 1] & ~e[(i + 1) % 8]).to(torch.int64)
    every = e[0]
    for i in range(1, 8):
        every = every & e[i]
    return torch.where(fill, runs + every.to(torch.int64), 0)
