"""Seeded mold captures, made on the device in a few large calls.

The image model of the port's ``synthetic.make_mold_image`` (the JAX
package's fixture): a bright background, a darker rounded mold surface in
each unit with a faint texture, in some units a bright foreign-material
speck on the surface, and Gaussian sensor noise. Its parameters are the
configuration's ``capture`` entry; a frame's shift moves every surface, as
a mold that moved between captures. The random draws come from one
``torch.Generator`` on the device, so a seed gives the same frames on any
card of one PyTorch build (not the same as the host fixture's pixels).
"""

from __future__ import annotations

import torch

from benchmark.reference.chain import unit_boxes


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def shifts(n: int, max_px: int, g: torch.Generator) -> list[tuple[int, int]]:
    """``n`` frame shifts (dx, dy): frame 0 (the reference capture) none,
    the others uniform in [-max_px, max_px] on each axis."""
    if max_px <= 0:
        return [(0, 0)] * n
    d = torch.randint(-max_px, max_px + 1, (n, 2), generator=g, device=g.device).tolist()
    return [(0, 0)] + [tuple(v) for v in d[1:]]


def make_frame(cfg: dict, shift: tuple[int, int], g: torch.Generator) -> torch.Tensor:
    """One [H, W] uint8 capture of configuration ``cfg`` on the generator's
    device."""
    cap = cfg["capture"]
    dev = g.device
    hh, ww = cfg["image_hw"]
    boxes = unit_boxes(cfg["grid"])
    u = len(boxes)
    _, _, w, h = boxes[0]

    def uniform(shape, half):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * half

    img = cap["background"] + uniform((hh, ww), cap["background_jitter"])
    sx, sy = shift
    mx, my = int(w * 0.15) + sx, int(h * 0.15) + sy
    sw, sh = int(w * 0.7), int(h * 0.7)
    rad = min(sw, sh) // 6
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    qx = xs.clamp(mx + rad, mx + sw - rad)
    qy = ys.clamp(my + rad, my + sh - rad)
    inside = (torch.hypot(xs - qx, ys - qy) <= rad) \
        | ((xs >= mx) & (xs < mx + sw) & (ys >= my + rad) & (ys < my + sh - rad)) \
        | ((ys >= my) & (ys < my + sh) & (xs >= mx + rad) & (xs < mx + sw - rad))
    level = cap["surface"] + uniform((u, 1, 1), cap["surface_jitter"])
    surface = level + uniform((u, h, w), cap["texture"])
    speck = torch.rand((u,), generator=g, device=dev) < cap["defect_rate"]
    cy = my + torch.randint(rad, sh - rad, (u,), generator=g, device=dev)
    cx = mx + torch.randint(rad, sw - rad, (u,), generator=g, device=dev)
    r = torch.randint(cap["speck_radius"][0], cap["speck_radius"][1] + 1, (u,), generator=g,
                      device=dev)
    blob = ((xs - cx[:, None, None]) ** 2 + (ys - cy[:, None, None]) ** 2
            <= (r * r)[:, None, None]) & inside & speck[:, None, None]
    bright = cap["speck"] + uniform((u, 1, 1), cap["speck_jitter"])

    org = torch.tensor([(x, y) for x, y, _, _ in boxes], device=dev)
    rows = (org[:, 1, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (org[:, 0, None] + torch.arange(w, device=dev))[:, None, :]
    units = img[rows, cols]
    units = torch.where(inside, surface, units)
    img[rows, cols] = torch.where(blob, bright, units)
    img = _psf(img, cap["psf_sigma"])
    img += torch.randn((hh, ww), generator=g, device=dev) * cap["noise"]
    return img.round().clamp(0, 255).to(torch.uint8)


def _psf(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """A separable Gaussian blur of ``sigma`` px (3 sigma a side, edges
    replicated) in float32 element-wise steps, which round alike on every
    device."""
    if sigma <= 0:
        return img
    r = max(1, int(3 * sigma + 0.5))
    t = torch.exp(-torch.arange(-r, r + 1, dtype=torch.float64) ** 2 / (2 * sigma * sigma))
    taps = (t / t.sum()).tolist()
    h, w = img.shape
    for dim, n in ((1, w), (0, h)):
        idx = torch.arange(-r, n + r, device=img.device).clamp(0, n - 1)
        p = img.index_select(dim, idx)
        out = torch.zeros_like(img)
        for k, c in enumerate(taps):
            out += c * p.narrow(dim, k, n)
        img = out
    return img


def make_pool(cfg: dict, n: int, seed: int, device,
              shift_px: int = 0) -> tuple[list[torch.Tensor], list]:
    """``n`` distinct captures from ``seed``, all but the first shifted by
    up to ``shift_px`` on each axis: (frames on ``device``, their
    shifts)."""
    g = generator(seed, device)
    sh = shifts(n, shift_px, g)
    return [make_frame(cfg, s, g) for s in sh], sh
