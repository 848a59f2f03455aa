"""Whole runs of the harness on the CPU at a small size (the port's plain
versions stand in for its kernels; no card is looked for): a sound program
comes out correct, and the control and each fault planted in the timed
path come out not correct."""

import pytest
import torch

from benchmark import compare, control
from benchmark.run import run_cell
from conftest import mix, small

CELLS = [("grid48-otsu-threshold", "ahead"), ("grid48-adaptive-canny", "ahead"),
         ("grid48-otsu-threshold", "anchored")]


@pytest.mark.parametrize("cfg,traffic", CELLS)
def test_sound_run_is_correct(cpu, cfg, traffic):
    run, out = run_cell(small(cfg), mix(traffic, pool=3), 2**31 + 99, 0.5, device=cpu)
    assert compare.passed(out["numbers"]) and run.frames
    assert all(f.answers is not None for f in run.frames)


def test_open_loop_times_every_frame_due(cpu):
    run, out = run_cell(small("grid48-otsu-threshold"), mix("ahead", pool=2, kind="open",
                                                             rate_per_s=4.0), 3, 1.0, device=cpu)
    assert compare.passed(out["numbers"])
    assert [round(f.due - run.t0, 6) for f in run.frames] == [0.0, 0.25, 0.5, 0.75]
    assert all(f.done >= f.start >= f.due for f in run.frames)


@pytest.mark.parametrize("cfg,traffic", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(cpu, cfg, traffic, seed):
    assert not compare.passed(control.readings(small(cfg), mix(traffic, pool=8), seed,
                                               torch.device(cpu)))


def _broken(kind):
    """The one-capture program with a fault planted in what it returns."""
    from tpu_inspect_torch import engine

    real = engine._inspect_image_device
    state = {}

    def program(*args):
        out = real(*args)
        if out[4] is None:  # the reference capture's anchors: no defect pass
            return out
        masks, sums, has_fg, shifts, (dm, found, area, verdict) = out
        if kind == "answer altered":  # one verdict flipped where it is made
            verdict = verdict.clone()
            verdict[0] = ~verdict[0]
        elif kind == "half the units left out":  # the second half never inspected
            half = masks.shape[0] // 2
            masks, dm, found, area, verdict = (t.clone() for t in (masks, dm, found, area, verdict))
            for t in (masks, dm, found, area, verdict):
                t[half:] = 0
        elif kind == "state unchanged":  # the previous frame's answers again
            prev = state.get("prev", out)
            state["prev"] = out
            return prev
        return masks, sums, has_fg, shifts, (dm, found, area, verdict)

    return program


@pytest.mark.parametrize("kind", ["answer altered", "half the units left out", "state unchanged"])
def test_planted_fault_is_not_correct(cpu, kind, monkeypatch):
    from tpu_inspect_torch import engine

    monkeypatch.setattr(engine, "_inspect_image_device", _broken(kind))
    _, out = run_cell(small("grid48-otsu-threshold"), mix("anchored", pool=3), 17, 0.5,
                      device=cpu)
    assert not compare.passed(out["numbers"])
