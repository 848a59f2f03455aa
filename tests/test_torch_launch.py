"""The collectives and the rank launcher of
``tpu_inspect_torch.parallel.launch`` on gloo ranks on the CPU, alone: the
halo exchange between strip neighbours at every seam (depths 1 and 3), an
uneven last strip, bool planes and a single rank without a process group;
the row gather with uneven counts and the sum; and a failing rank, which
fails the whole call with its traceback.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_inspect_torch.parallel import launch
from tpu_inspect_torch.parallel.launch import Mesh, all_gather_rows, all_sum, exchange_rows

WORLD = 4


def _plane(h, w, seed, dtype=torch.int64):
    g = torch.from_numpy(np.random.RandomState(seed).randint(0, 1000, (h, w)))
    return g.to(dtype) if dtype != torch.bool else g % 2 == 1


def _strips(h, n=WORLD):
    hs = -(-h // n)
    return [(i * hs, min(h, (i + 1) * hs)) for i in range(n)]


# (name, plane, depth): each rank exchanges its own strip of the plane
CASES = [
    ("even depth 1", _plane(12, 5, 0), 1),
    ("even depth 3", _plane(12, 5, 1), 3),
    ("uneven last strip", _plane(10, 7, 2), 1),  # strips of 3, 3, 3, 1 rows
    ("bool", _plane(16, 4, 3, torch.bool), 2),
]


def _rank_calls(rank):
    # the default group's ranks as a 1-D mesh (group None: the default group)
    mesh = Mesh(("strip",), (WORLD,), rank, torch.device("cpu"))
    calls = []
    for _, plane, depth in CASES:
        lo, hi = _strips(plane.shape[0])[rank]
        calls.append(functools.partial(exchange_rows, plane[lo:hi].clone(), depth, mesh))
    lo, hi = _strips(10)[rank]
    calls.append(functools.partial(all_gather_rows, _plane(10, 3, 4)[lo:hi].clone(), mesh,
                                   counts=[b - a for a, b in _strips(10)]))
    calls.append(functools.partial(all_sum, torch.full((2, 3), rank + 1, dtype=torch.int64),
                                   mesh))
    return calls


@pytest.fixture(scope="module")
def runs():
    """Every case on 4 spawned gloo ranks: [rank][case]."""
    return launch.run_spmd(launch.run_calls, WORLD, "gloo", device="cpu",
                           args=[(_rank_calls(r),) for r in range(WORLD)], timeout=300)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_exchange_rows_at_every_seam(runs, case):
    _, plane, depth = CASES[case]
    strips = _strips(plane.shape[0])
    for rank, (lo, hi) in enumerate(strips):
        above, below = runs[rank][case]
        if rank == 0:
            assert above is None
        else:
            assert above.dtype == plane.dtype
            torch.testing.assert_close(above, plane[lo - depth : lo], rtol=0, atol=0)
        if rank == WORLD - 1:
            assert below is None
        else:
            torch.testing.assert_close(below, plane[hi : hi + depth], rtol=0, atol=0)


def test_gather_uneven_rows_and_sum(runs):
    whole = _plane(10, 3, 4)
    for rank in range(WORLD):
        torch.testing.assert_close(runs[rank][len(CASES)], whole, rtol=0, atol=0)
        assert runs[rank][len(CASES) + 1].tolist() == [[10] * 3] * 2


def test_one_rank_without_a_process_group():
    mesh = Mesh(("strip",), (1,), 0, torch.device("cpu"))
    x = _plane(5, 3, 7)
    assert exchange_rows(x, 2, mesh) == (None, None)
    assert all_gather_rows(x, mesh) is x
    assert all_sum(x, mesh) is x
    with pytest.raises(ValueError, match="a strip of 5 rows for a halo of 6"):
        exchange_rows(x, 6, mesh)


def test_a_failing_rank_fails_the_call():
    """Every rank refuses a 3-image mesh over 2 ranks; run_spmd raises with
    a rank's traceback and leaves no rank running."""
    from tpu_inspect_torch.parallel.mesh import image_unit_mesh

    with pytest.raises(RuntimeError, match="2 ranks not divisible by 3 images"):
        launch.run_spmd(functools.partial(image_unit_mesh, 3), 2, "gloo", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        launch.run_spmd(launch.run_calls, 2, "mpi", device="cpu")
