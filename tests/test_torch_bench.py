"""The port's benchmark runner (``tpu_inspect_torch.bench``) on the CPU.

Its building blocks take the workload, N and the device, so every form runs
here small (4 units of 64x60, N = 3, ``device="cpu"``): the chained loop
against N single calls of the engine with the bump applied by hand, each
form's gate against the oracle copy (and against a corrupted one), the
metric line against the root ``bench.py``'s ``_emit``, ``cli bench`` and
the forms without a CUDA device.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench as jbench

from tpu_inspect_torch import bench, cli, oracle
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.kernels import error_flag
from tpu_inspect_torch.synthetic import make_mold_image

ROOT = Path(__file__).resolve().parent.parent
GRID = GridParams(base_unit=(6, 8, 64, 60), units_x=2, units_y=2, unit_space_x=10,
                  unit_space_y=12)
SMALL = dict(n=3, reps=2)

FORMS = {
    "headline": (lambda **kw: bench.main(combo_units=4, **kw), [bench.HEADLINE]),
    "config1": (lambda **kw: bench.main_config1(False, **kw), [bench.CONFIG1]),
    "config1defect": (lambda **kw: bench.main_config1(True, **kw), [bench.CONFIG1_DEFECT]),
    "stream": (lambda **kw: bench.main_stream(n_warm=2, n_meas=3, **kw),
               [bench.STREAM_DEVICE, bench.STREAM_WALL]),
}


def _workload():
    """The standard workload's dict at 4 units of 64x60 (seed 3, defect rate
    0.6: defect areas of odd sums, so the chained bump flips the image; one
    circle exclusion inside the units)."""
    return {
        "grid": GRID,
        "image": make_mold_image(GRID, (150, 160), seed=3, defect_rate=0.6),
        "origins": grid_origins(GRID),
        "exclusions": [{"shape": "circle", "cx": 30, "cy": 30, "r": 6}],
        "unit_hw": (60, 64),
    }


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("case", [
    (1.23456, 100.0, None, None),
    (1.5, 10.0, None, [1.2, 1.5, 1.94449]),
    (2.0, 5.0, "a warning", [2.0]),
    (0.0, 5.0, None, None),
    (float("nan"), 10.0, None, [1.0]),
    (float("inf"), 10.0, None, None),
    (float("-inf"), 10.0, "overflow", None),
    (None, 0.0, "device unavailable: none", None),
    (None, 3.0, None, [1.0, 2.0]),
])
def test_emit_matches_bench_emit(case, capsys):
    value, cpu_ms, error, samples = case
    jbench._emit("m", value, cpu_ms, error=error, samples=samples)
    ref = capsys.readouterr().out
    bench._emit("m", value, cpu_ms, error=error, samples=samples, device="NVIDIA H100")
    got = capsys.readouterr().out
    assert ref.count("\n") == got.count("\n") == 1
    ref, got = json.loads(ref), json.loads(got)
    assert list(got) == list(ref) + ["device"] and got.pop("device") == "NVIDIA H100"
    assert got == ref
    assert got["value"] is None or math.isfinite(got["value"])


def _by_hand(step_kind, x, n, wl, seg, dp):
    """N single engine calls with the bump applied by hand."""
    acc, flips = 0, 0
    origins = torch.from_numpy(wl["origins"])
    for i in range(n):
        if step_kind == "image" or step_kind == "frames":
            img = x if step_kind == "image" else x[i % x.shape[0]]
            out = teng._inspect_image_device(img, origins, wl["unit_hw"], seg, dp,
                                             wl["exclusions"], None, True, True)
            a, b = int(out[4][2].sum()), int(out[4][3].sum())
        else:
            m, _ = teng._seg_mask(x, seg)
            a = int(m.to(torch.int64).sum())
            if step_kind == "unit defect":
                a += int(teng._defect(x, m, dp)[2].sum())
            b = a
        acc += b
        flips += a & 1
        x = x ^ (a & 1)
    return acc, x, flips


@pytest.mark.parametrize("kind", ["image", "frames", "unit", "unit defect"])
def test_chained_loop_equals_single_calls(kind, monkeypatch):
    """:func:`bench.chain` over each form's step equals N = 3 single engine
    calls with ``x ^ (a & 1)`` applied by hand: the accumulator and the
    final image; the seeds make the bump flip the image at least once. The
    unit forms take the whole-image route (its gate lowered)."""
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    wl = _workload()
    seg, dp = SegmentationParams().validated(), DefectParams().validated()
    origins = torch.from_numpy(wl["origins"])
    img = torch.from_numpy(wl["image"])
    err = error_flag("cpu")
    if kind == "image":
        x, step = img, bench.image_step(origins, wl["unit_hw"], seg, dp, wl["exclusions"], err)
    elif kind == "frames":
        other = torch.from_numpy(make_mold_image(GRID, (150, 160), seed=1, defect_rate=0.6))
        x = torch.stack([img, other])
        step = bench.frames_step(origins, wl["unit_hw"], seg, dp, wl["exclusions"], err)
    else:
        x = img[None, :117].contiguous()  # a cut unit row: the seg mask's count is odd
        step = bench.unit_step(seg, dp if kind == "unit defect" else None, err)
    acc, out = bench.chain(step, x, 3)
    ref_acc, ref_x, flips = _by_hand(kind, x, 3, wl, seg, dp)
    assert acc.dtype == torch.int32 and int(acc) == ref_acc
    assert torch.equal(out, ref_x) and flips > 0
    assert int(err) == 0


@pytest.mark.parametrize("form", list(FORMS))
def test_forms_run_small_on_cpu(form, capsys, monkeypatch):
    """Each form's gate holds on the small workload (config1 on the
    whole-image route, its gate lowered) and it prints its metric lines:
    finite values, N = 2 windows, the device's name."""
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    run, metrics = FORMS[form]
    run(workload=_workload(), device="cpu", **SMALL)
    lines = _lines(capsys)
    assert [r["metric"] for r in lines] == metrics
    for r in lines:
        assert r["value"] > 0 and "error" not in r and r["device"] == "cpu"
        assert r["n"] == (3 if r["metric"] == bench.STREAM_WALL else 2)


def _corrupt_areas(real):
    def corrupted(*args, **kwargs):
        masks, areas, verdicts = real(*args, **kwargs)
        return masks, areas + 1, verdicts

    return corrupted


@pytest.mark.parametrize("form", list(FORMS))
def test_gate_with_corrupted_oracle_fails(form, capsys, monkeypatch):
    """An oracle whose areas (config1: whose mask) are off by one fails the
    gate: every metric line of the form is null with the gate's error, and
    the form exits 1."""
    if form == "config1":
        real = oracle.segment_unit
        monkeypatch.setattr(oracle, "segment_unit", lambda *a, **k: real(*a, **k) ^ 255)
    else:
        monkeypatch.setattr(oracle, "inspect_units", _corrupt_areas(oracle.inspect_units))
    run, metrics = FORMS[form]
    with pytest.raises(SystemExit) as e:
        run(workload=_workload(), device="cpu", **SMALL)
    assert e.value.code == 1
    lines = _lines(capsys)
    assert [r["metric"] for r in lines] == metrics
    for r in lines:
        assert r["value"] is None and r["error"] == "parity gate failed"


@pytest.mark.parametrize("form", list(FORMS))
def test_forms_without_cuda_print_the_error_and_exit_1(form, capsys, monkeypatch):
    """With no CUDA device every form prints one error line a metric and
    exits 1 before any work: none runs on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run, metrics = FORMS[form]
    with pytest.raises(SystemExit) as e:
        run()
    assert e.value.code == 1
    lines = _lines(capsys)
    assert [r["metric"] for r in lines] == metrics
    for r in lines:
        assert r["value"] is None and r["error"].startswith("device unavailable")
        assert r["device"] is None


def test_main_module_without_cuda_exits_1():
    """``python -m tpu_inspect_torch.bench stream`` with no visible card:
    two error lines on stdout, exit 1; an unknown form exits non-zero with
    its usage and no line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "tpu_inspect_torch.bench", "stream"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode == 1
    lines = [json.loads(s) for s in p.stdout.strip().splitlines()]
    assert [r["metric"] for r in lines] == [bench.STREAM_DEVICE, bench.STREAM_WALL]
    assert all(r["value"] is None for r in lines)
    p = subprocess.run([sys.executable, "-m", "tpu_inspect_torch.bench", "bogus"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and not p.stdout and "usage" in p.stderr


def test_cli_bench_dispatches_to_the_runner(monkeypatch):
    """``cli bench`` is registered, takes no device flag and runs
    ``tpu_inspect_torch.bench.main``."""
    calls = []
    monkeypatch.setattr(bench, "main", lambda: calls.append(True))
    cli.main(["bench"])
    assert calls == [True]
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu"])
    assert e.value.code == 2 and calls == [True]
