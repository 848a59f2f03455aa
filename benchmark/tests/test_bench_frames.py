"""The seeded captures: the same seed gives the same pool, another seed
another, on the CPU."""

import torch

from benchmark import frames
from conftest import mix, small


def test_pool_is_fixed_by_the_seed():
    cfg = small("grid48-otsu-threshold")
    px = mix("anchored")["shift_px"]
    a, sa = frames.make_pool(cfg, 3, 2**31 + 7, "cpu", px)
    b, sb = frames.make_pool(cfg, 3, 2**31 + 7, "cpu", px)
    c, _ = frames.make_pool(cfg, 3, 2**31 + 8, "cpu", px)
    assert sa == sb and sa[0] == (0, 0)
    assert all(max(abs(dx), abs(dy)) <= 8 for dx, dy in sa)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert a[0].dtype == torch.uint8 and tuple(a[0].shape) == tuple(cfg["image_hw"])


def test_unshifted_mix_has_no_shift():
    _, s = frames.make_pool(small("grid48-adaptive-canny"), 4, 5, "cpu")
    assert s == [(0, 0)] * 4
