"""The port's spans in the benchmark, on the CPU: the host-fed cell runs
correct at a small size and its planted faults do not; its traced run's
spans reach the new readers (the device slice's host waits read None
without a card); the breakdown's entries keep their form; the clock
mapping puts a bracketed event on its trace event, and the idle seconds
and host waits fall under the spans open on the host."""

import time

import numpy as np
import pytest
import torch

from benchmark import compare, spans
from benchmark import trace as bench_trace
from benchmark.run import reader, run_cell
from benchmark.trace import Slice, _read, breakdown
from conftest import mix, small
from test_bench_run import _broken

CFG = "grid48-otsu-threshold"
READERS = ["glue_host_ms_per_frame", "kernel_host_ms_per_frame", "stream_upload_ms_per_frame",
           "stream_fetch_ms_per_frame"]


def test_hostfeed_is_correct(cpu):
    run, out = run_cell(small(CFG), mix("hostfeed", pool=3), 2**31 + 7, 0.5, device=cpu)
    assert compare.passed(out["numbers"]) and run.frames
    assert all(f.answers is not None and f.done >= f.start for f in run.frames)
    assert [f.pool for f in run.frames] == [i % 3 for i in range(len(run.frames))]


@pytest.mark.parametrize("kind", ["answer altered", "state unchanged"])
def test_hostfeed_planted_fault_is_not_correct(cpu, kind, monkeypatch):
    from tpu_inspect_torch import streaming

    monkeypatch.setattr(streaming, "_inspect_image_device", _broken(kind))
    _, out = run_cell(small(CFG), mix("hostfeed", pool=3), 2**31 + 7, 0.5, device=cpu)
    assert not compare.passed(out["numbers"])


def test_hostfeed_refused_frame_is_unanswered(cpu, monkeypatch):
    from tpu_inspect_torch import streaming

    real = streaming._inspect_image_device

    def refused(*args):
        out = real(*args)
        args[-1].fill_(1)  # the frame's bound flag, as a kernel sets it
        return out

    monkeypatch.setattr(streaming, "_inspect_image_device", refused)
    run, out = run_cell(small(CFG), mix("hostfeed", pool=3), 2**31 + 7, 0.3, device=cpu)
    assert out["numbers"]["unanswered"] > 0 and not compare.passed(out["numbers"])


def test_traced_hostfeed_run_feeds_the_readers(cpu, monkeypatch):
    monkeypatch.setattr(bench_trace, "DEVICE_SLICE_FRAMES", 2)
    monkeypatch.setattr(bench_trace, "HOST_SLICE_FRAMES", 2)
    run, out = run_cell(small(CFG), mix("hostfeed", pool=3), 2**31 + 7, 2.0, trace=True,
                        device=cpu)
    assert compare.passed(out["numbers"])
    got = {m: reader(m)(run) for m in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert reader("host_waits_per_frame")(run) is None  # no card, no runtime events
    outside = [f for f in run.frames if f.index not in run.in_slice]
    assert outside and all(f.spans["route"] == "frame.chained" for f in run.frames)
    glue = np.mean([f.spans["frame_ns"] - f.spans["kernel_ns"] for f in outside]) * 1e-6
    assert got["glue_host_ms_per_frame"] == pytest.approx(glue)
    dev = run.slices["device"]
    assert dev.anchors and dev.spans and set(run.slices) == {"device", "host"}


def test_readers_find_nothing_in_an_untraced_run(cpu):
    run, _ = run_cell(small(CFG), mix("ahead", pool=2), 5, 0.3, device=cpu)
    assert all(reader(m)(run) is None for m in READERS + ["host_waits_per_frame"])


def test_breakdown_keeps_its_form():
    dev = Slice(frames=2, wall_s=1.0, device=[("void k<1>(int*)", 0.0, 10.0),
                                               ("Memcpy DtoH (Device -> Pinned)", 30.0, 5.0)])
    host = Slice(frames=2, wall_s=1.0, device=[("void k<1>(int*)", 0.0, 10.0),
                                                ("void j(int)", 40.0, 10.0)],
                 host=[("bench.dispatch", "user_annotation", 5.0, 40.0),
                       ("aten::zeros", "cpu_op", 12.0, 20.0)])
    out = breakdown({"device": dev, "host": host})
    assert list(out) == ["device_ops", "idle_gaps"]
    assert out["device_ops"] == [["k", pytest.approx(1e-05)], ["Memcpy DtoH", pytest.approx(5e-06)]]
    assert out["idle_gaps"] == [["bench.dispatch: zeros", pytest.approx(3e-05)]]


def _clock_slice():
    """A CPU profile of anchors at both ends and a bracketed probe range
    between them (the first range of a process is slow, so one goes
    first)."""
    with torch.profiler.record_function("warm"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        anchors = [spans.anchor()]
        time.sleep(0.02)
        a = time.perf_counter_ns()
        with torch.profiler.record_function("probe"):
            pass
        b = time.perf_counter_ns()
        time.sleep(0.02)
        anchors.append(spans.anchor())
    _, host = _read(prof)
    return anchors, host, (a, b)


def test_clock_puts_a_bracketed_event_on_its_trace_event():
    anchors, host, (a, b) = _clock_slice()
    clock = spans.Clock(anchors, host)
    (_, _, s, d), = [e for e in host if e[0] == "probe"]
    assert len(clock.offset) + clock.dropped == 2 and clock.error_us < 50
    # the probe's host bracket, on the trace's clock, holds its event
    assert clock(a) - 50 < s and s + d < clock(b) + 50


def test_clock_is_linear_between_anchors():
    # trace = host / 1000 - 100 at the first anchor, - 102 at the second
    events = [("cudaDeviceSynchronize", "cuda_runtime", 900.0 - 1.0, 2.0),
                ("cudaDeviceSynchronize", "cuda_runtime", 1898.0 - 1.0, 2.0)]
    clock = spans.Clock([(999_000, 1_001_000), (1_999_000, 2_001_000)], events)
    assert clock.drift_us == pytest.approx(2.0)
    assert clock(1_000_000) == pytest.approx(900.0)
    assert clock(1_500_000) == pytest.approx(1399.0)
    assert clock(2_000_000) == pytest.approx(1898.0)


def test_clock_drops_an_anchor_with_a_wide_bracket():
    # the first synchronize spent 2 ms of host time around a 10 us call
    events = [("cudaDeviceSynchronize", "cuda_runtime", t, 10.0) for t in (100.0, 600.0, 1100.0)]
    anchors = [(2_100_000, 4_120_000), (2_595_000, 2_625_000), (3_095_000, 3_125_000)]
    clock = spans.Clock(anchors, events)
    assert clock.dropped == 1 and clock.error_us == pytest.approx(10.0)
    assert clock.drift_us == 0.0 and clock(2_600_000) == pytest.approx(595.0)


def _mapped_slice():
    """A slice on a clock where trace us = host ns / 1000: two frames of
    spans, the card busy [0, 10) and [50, 60) and [100, 110)."""
    recs = [(1, "frame.split", "gather", 12_000, 20_000),
            (1, "frame.split/seg.tail", "kernel.seg_tail", 22_000, 30_000),
            (1, "frame.split", "seg.tail", 21_000, 32_000),
            (1, "", "frame.split", 11_000, 40_000),
            (2, "", "stream.fetch", 70_000, 90_000)]
    sl = Slice(frames=2, wall_s=1.0,
               device=[("k", 0.0, 10.0), ("k", 50.0, 10.0), ("k", 100.0, 10.0)],
               host=[("cudaDeviceSynchronize", "cuda_runtime", 0.0, 0.0),
                     ("cudaStreamSynchronize", "cuda_runtime", 25.0, 1.0),
                     ("cudaMemcpyAsync", "cuda_runtime", 26.0, 1.0),
                     ("cudaStreamSynchronize", "cuda_runtime", 80.0, 1.0)])
    sl.spans, sl.anchors = recs, [(0, 0)]
    return sl


def test_idle_falls_under_the_innermost_span():
    got = dict(spans.idle_by_span(_mapped_slice()))
    # gap 10-50: outside 10-11 and 40-50, the root 11-12, 20-21 and 32-40,
    # gather 12-20, seg.tail 21-22 and 30-32, the kernel 22-30; gap 60-100:
    # the fetch 70-90, outside the rest
    want = {"outside": 11 + 20, "frame.split": 10, "frame.split/gather": 8,
            "frame.split/seg.tail": 3, "kernel.seg_tail": 8, "stream.fetch": 20}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()})


def test_host_waits_count_blocking_calls_inside_frames():
    sl = _mapped_slice()
    assert spans.host_waits(sl) == 0.5  # the one inside frame.split, over 2 frames
    sl.host = [e for e in sl.host if e[0] == "cudaDeviceSynchronize"]
    assert spans.host_waits(sl) == 0.0
