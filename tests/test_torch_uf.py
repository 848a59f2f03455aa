"""Kernels D and E (the tiled run union-find of ``csrc/uf.cuh``) against
their plain versions, on a GPU.

A tile is 16 rows x 512 columns on planes wider than 512 pixels (16 words
a tile row; narrower planes take all their words and 256 / words rows),
so the planes here cross tile seams and the corners where four tiles meet
in both directions. Each case holds kernel D's four forms (seeded and
border-seeded, 4- and 8-connected) and kernel E exactly against
``propagate_plain`` / ``label_components_plain``; where the plain fixpoint
would take long (a spiral and a serpentine), against the known answer. Every
test carries the ``cuda`` marker and skips without a GPU; the file imports
neither jax nor tpu_inspect:

    python -m pytest tests/test_torch_uf.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch.kernels import LAUNCHES, build, error_flag, reset_launches
from tpu_inspect_torch.ops.cc import BIG, label_components, label_components_plain
from tpu_inspect_torch.ops.flood import propagate, propagate_plain
from tpu_inspect_torch.synthetic import serpentine_plane

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), f"{int((got != ref).sum())} pixels differ"


def _all_forms(dom, seed):
    """Kernel D's four forms and kernel E on ``dom`` [U, H, W] uint8 (0/1 or
    0/255), D seeded with ``seed``, each against its plain version; every
    form reads one shared bound flag, read once at the end."""
    err = error_flag(dom.device)
    reset_launches()
    for conn8 in (True, False):
        _equal(propagate(seed, dom, conn8, err=err), propagate_plain(seed, dom, conn8))
        _equal(propagate(None, dom, conn8, border_seed=True, err=err),
               propagate_plain(None, dom, conn8, border_seed=True))
    _equal(label_components(dom, err=err), label_components_plain(dom))
    build.check_bounded("uf forms", err)
    assert LAUNCHES["propagate"] == 4 and LAUNCHES["label"] == 1


def _staircase(h, w, anti=False):
    m = np.zeros((h, w), np.uint8)
    for i in range(min(h, w)):
        m[i, w - 1 - i if anti else i] = 1
    return m


def _spiral(n):
    """A 1-px square spiral wall with a 1-px corridor between its turns
    (fg one 8-connected component from (0, 0); the corridor reaches the
    border at (1, 0))."""
    m = np.zeros((n, n), np.uint8)
    lens = [n - 1, n - 1, n - 1]
    step = n - 3
    while step > 0:
        lens += [step, step]
        step -= 2
    y = x = 0
    m[0, 0] = 1
    for i, length in enumerate(lens):
        dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = 1
    return m


def _seed_like(dom, p, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(*dom.shape) < p).astype(np.uint8)).to(dom.device)


@pytest.mark.parametrize("case", ["checkerboard", "staircases", "anti-staircase bands"])
def test_uf_seams_and_corners_match_plain(cuda, case):
    """Planes whose components cross tile seams and corners: a
    checkerboard (8-connected: one component; 4-connected: every pixel
    alone), a diagonal staircase through the corner at (512, 512) and an
    anti-diagonal one on 1x600x1100 planes, and anti-diagonal staircases
    every 31 columns (one through the corner: (511, 512) to (512, 511))."""
    if case == "checkerboard":
        p = (np.add.outer(np.arange(70), np.arange(1100)) % 2 == 0)[None]
    elif case == "staircases":
        p = np.stack([_staircase(600, 1100), _staircase(600, 1100, anti=True)])
    else:
        yy, xx = np.mgrid[:600, :1100]
        p = ((yy + xx) % 31 == 0)[None]
    dom = torch.from_numpy(np.ascontiguousarray(p).astype(np.uint8)).to(cuda)
    _all_forms(dom, _seed_like(dom, 0.001, 1))


@pytest.mark.parametrize("w", [1, 31, 32, 33, 315, 316])
def test_uf_word_edges_match_plain(cuda, w):
    """Widths at and around the 32-pixel word (and one), a unit of H = 1
    beside them, an empty and a full unit: bits past W must stay out of
    every run."""
    rng = np.random.RandomState(w)
    p = (rng.rand(4, 600, w) > 0.45).astype(np.uint8)
    p[0] = 0
    p[1] = 1
    dom = torch.from_numpy(p).to(cuda)
    _all_forms(dom, _seed_like(dom, 0.01, w))
    row = torch.from_numpy((rng.rand(3, 1, w + 700) > 0.3).astype(np.uint8)).to(cuda)
    _all_forms(row, _seed_like(row, 0.01, w + 1))


@pytest.mark.parametrize("fill", [0, 1])
def test_uf_solid_planes_match_plain(cuda, fill):
    """All-off and all-on planes, a batch of three small units and one of
    3 units of 1000x1100 (the all-on one a single component per unit, every
    pixel labelled 0)."""
    for shape in ((3, 19, 45), (3, 1000, 1100)):
        dom = torch.full(shape, fill, dtype=torch.uint8, device=cuda)
        seed = torch.zeros_like(dom)
        seed[1, -1, -1] = 1
        _all_forms(dom, seed)
    lab = label_components(dom)
    torch.cuda.synchronize()
    assert int(lab.max()) == (0 if fill else BIG) and int(lab.min()) == (0 if fill else BIG)


def test_uf_small_unit_batch_matches_plain(cuda):
    """A U = 3 batch of small random units: runs never join across units."""
    rng = np.random.RandomState(3)
    dom = torch.from_numpy((rng.rand(3, 37, 53) > 0.4).astype(np.uint8)).to(cuda)
    _all_forms(dom, _seed_like(dom, 0.03, 4))


@pytest.mark.parametrize("case", ["spiral", "serpentine"])
def test_uf_long_paths_known_answer(cuda, case):
    """A 1023 x 1023 spiral (one 1-px wall over 2x64 tiles) and a 1-px
    serpentine of 68k px over 3x16 tiles, where the plain fixpoint would need
    a round per turn or per pixel: the path is one component labelled 0, a
    seed at its far end reaches all of it, and (spiral) the border flood of
    the corridor reaches every background pixel."""
    p = _spiral(1023) if case == "spiral" else serpentine_plane(250, 1100)
    sp = torch.from_numpy(p[None]).to(cuda)
    err = error_flag(cuda)
    lab = label_components(sp, err=err)
    tip = torch.zeros_like(sp).flatten()
    tip[sp.flatten().nonzero().max()] = 1
    reached = propagate(tip.reshape(sp.shape), sp, True, err=err)
    ext = propagate(None, (1 - sp).contiguous(), False, border_seed=True, err=err)
    build.check_bounded(case, err)
    assert torch.equal(lab[sp > 0], torch.zeros_like(lab[sp > 0]))
    assert torch.equal(lab[sp == 0], torch.full_like(lab[sp == 0], BIG))
    assert torch.equal(reached, sp > 0)
    if case == "spiral":
        assert torch.equal(ext, sp == 0)
