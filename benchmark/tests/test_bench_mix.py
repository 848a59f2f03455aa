"""The traffic kinds: each mix file names a kind found by its name under
``traffic/``, the open kind's schedule, the moving kind's shifted pool and
anchors, and the chained route set by the configuration whatever imported
the engine first."""

import json

import pytest
import torch

from benchmark import frames, mix
from benchmark.program import Program
from conftest import HERE, small
from conftest import mix as mix_file


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_mix_names_a_kind_found_by_name(path):
    traffic = json.loads(path.read_text())
    assert (HERE / "traffic" / f"{traffic['kind']}.py").exists()
    k = mix.load(traffic)
    assert isinstance(k, mix.Mix) and type(k).run is not mix.Mix.run
    assert traffic["pool"] >= 1 and traffic["in_flight"] >= 1


def test_open_schedule_is_even():
    k = mix.load({"kind": "open", "pool": 2, "in_flight": 3, "rate_per_s": 4.0})
    assert [k.due(i) for i in range(5)] == [0.0, 0.25, 0.5, 0.75, 1.0]


def test_moving_kind_shifts_the_pool_and_anchors_the_program():
    cfg = small("grid48-otsu-threshold")
    k = mix.load(mix_file("anchored", pool=3))
    still = mix.load(mix_file("ahead", pool=3))
    assert k.anchored and not still.anchored
    moved, fixed = k.pool(cfg, 11, "cpu"), still.pool(cfg, 11, "cpu")
    want, shifts = frames.make_pool(cfg, 3, 11, "cpu", 8)
    assert all(torch.equal(a, b) for a, b in zip(moved, want)) and any(s != (0, 0) for s in shifts)
    assert all(torch.equal(a, b) for a, b in zip(fixed, frames.make_pool(cfg, 3, 11, "cpu")[0]))

    class Seen:
        ref = None

        def set_reference(self, image):
            self.ref = image

    p = Seen()
    k.prepare(p, moved)
    assert p.ref is moved[0]
    still.prepare(p := Seen(), fixed)
    assert p.ref is None


@pytest.mark.parametrize("name,chained", [("grid48-otsu-threshold", True),
                                          ("grid48-adaptive-canny", False)])
def test_chained_route_follows_the_configuration(name, chained):
    from tpu_inspect_torch import engine

    saved = engine._ENABLE_CHAIN
    try:
        engine._ENABLE_CHAIN = not chained  # as an earlier import may have left it
        Program(small(name), torch.device("cpu"))
        assert engine._ENABLE_CHAIN is chained
    finally:
        engine._ENABLE_CHAIN = saved
