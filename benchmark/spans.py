"""The port's spans (``tpu_inspect_torch.utils.trace``) in a run, and on the
device trace's clock.

A run that turns the spans on for its window gives each frame a summary
(:func:`assign`: its route, the root span, the ``kernel.*`` spans inside
it, and the stream's upload and fetch spans), which the ``program_span``
readers average over the frames outside the profiled slices. A profiled
slice holds, beside the profiler's events, the window's span records and
the slice's clock anchors (:func:`anchor`: a call both clocks see, a
``torch.cuda.synchronize()`` bracketed by host clock reads); the
:class:`Clock` fitted to them puts the spans on the trace's timestamps, so
:func:`host_waits` and :func:`idle_by_span` can ask what the program was
doing when the card waited or idled.

``python3 -m benchmark.spans --workload <cell> --seed <n>`` runs a cell's
program with the spans on, outside the benchmark's window, and prints one
JSON line: the spans' host cost off and on, glue and kernel milliseconds a
frame, and over a device-only profiler slice the clock's offset and drift,
the share of the hand kernels' launches inside a ``kernel.*`` span (matched
by the trace's correlation ids), the host waits a frame and the idle
seconds by span.
"""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

ANCHOR_EVENTS = ("cudaDeviceSynchronize", "spans.clock")
# CUDA API calls that block the host until the card catches up
BLOCKING = {"cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
            "cuStreamSynchronize", "cuEventSynchronize", "cuCtxSynchronize"}


def anchor() -> tuple[int, int]:
    """A call both clocks see, bracketed by ``time.perf_counter_ns()``
    reads (take two where a slice begins: :class:`Clock` drops one whose
    bracket is wide): on a card a device synchronize, called without
    ``torch.cuda.synchronize``'s Python around it so that the bracket is
    a few microseconds wider than the call (a ``cudaDeviceSynchronize``
    runtime event in any slice that records the card), without one a
    profiler range ``spans.clock``."""
    if torch.cuda.is_available():
        torch.cuda.init()
        sync = getattr(torch._C, "_cuda_synchronize", torch.cuda.synchronize)
        a = time.perf_counter_ns()
        sync()
        return a, time.perf_counter_ns()
    a = time.perf_counter_ns()
    with torch.profiler.record_function("spans.clock"):
        pass
    return a, time.perf_counter_ns()


def is_blocking(name: str) -> bool:
    """A host wait for the card: a synchronize, or a copy without Async."""
    return name in BLOCKING or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                                and "Async" not in name)


class Clock:
    """Host ``perf_counter_ns`` -> trace microseconds, from the anchors
    taken in a slice and their events in it (the k-th anchor is the k-th
    anchor event). The event lies inside its host bracket, which bounds the
    offset between the clocks to an interval; the anchors whose interval is
    within twice the narrowest's (and 10 us) are kept, the rest dropped (a
    slice's first synchronize can spend milliseconds of host time around a
    short call). The offset is each kept interval's middle, linear in
    between and constant beyond the first and the last."""

    def __init__(self, anchors: list[tuple[int, int]], events: list):
        evs = sorted((s, d) for n, _, s, d in events if n in ANCHOR_EVENTS)
        pairs = list(zip(anchors, evs))
        if not pairs:
            raise ValueError("no anchor event in the slice")
        # the offset (host us - trace us) lies in [a - s, b - s - d]
        width = [(b - a) / 1e3 - d for (a, b), (_, d) in pairs]
        tight = 2 * min(width) + 10.0
        kept = [(p, w) for p, w in zip(pairs, width) if w <= tight]
        self.dropped = len(pairs) - len(kept)
        self.error_us = max(w for _, w in kept) / 2
        self.host = [(a + b) / 2e3 for ((a, b), _), _ in kept]
        self.offset = [h - (s + d / 2) for h, (((_, _), (s, d)), _) in zip(self.host, kept)]

    @property
    def drift_us(self) -> float:
        """How far the offset moved from the slice's first anchor to its
        last."""
        return self.offset[-1] - self.offset[0]

    def __call__(self, t_ns: int) -> float:
        h = t_ns / 1e3
        return h - float(np.interp(h, self.host, self.offset))


def _trees(records) -> dict[int, dict]:
    """Each root's tree: its name, host span, the ``kernel.*`` spans
    outermost inside it and its ``stream.slot_wait`` spans."""
    out: dict[int, dict] = {}
    kern: dict[int, int] = {}
    wait: dict[int, int] = {}
    for fid, parent, name, t0, t1 in records:
        if not parent:
            out[fid] = {"name": name, "t0": t0, "t1": t1}
        elif name.startswith("kernel.") and "kernel." not in parent:
            kern[fid] = kern.get(fid, 0) + t1 - t0
        elif name == "stream.slot_wait":
            wait[fid] = wait.get(fid, 0) + t1 - t0
    for fid, t in out.items():
        t["kernel_ns"], t["slot_wait_ns"] = kern.get(fid, 0), wait.get(fid, 0)
    return out


def assign(frames, records) -> None:
    """Give each of ``frames`` (dispatched in order while the spans were
    on) ``f.spans``: its route, ``frame_ns`` (the root span), ``kernel_ns``
    (the ``kernel.*`` spans inside it) and, from a stream, ``upload_ns``
    (``slot_wait_ns`` of it) and ``fetch_ns``. Each frame makes one root of
    each kind in turn, so the last roots of a kind belong to the last
    frames (a full buffer drops the oldest)."""
    trees = sorted(_trees(records).values(), key=lambda t: t["t0"])
    kinds = {"frame": [t for t in trees if t["name"].startswith("frame.")],
             "upload": [t for t in trees if t["name"] == "stream.upload"],
             "fetch": [t for t in trees if t["name"] == "stream.fetch"]}
    for f in frames:
        f.spans = {}
    for kind, ts in kinds.items():
        n = min(len(ts), len(frames))
        for f, t in zip(frames[len(frames) - n:], ts[len(ts) - n:]):
            if kind == "frame":
                f.spans.update(route=t["name"], frame_ns=t["t1"] - t["t0"],
                               kernel_ns=t["kernel_ns"])
            else:
                f.spans[f"{kind}_ns"] = t["t1"] - t["t0"]
                if kind == "upload":
                    f.spans["slot_wait_ns"] = t["slot_wait_ns"]


def frame_mean_ms(run, value) -> float | None:
    """The mean of ``value(f.spans)`` in ms over the window's frames outside
    the profiled slices that carry it (None where none does)."""
    vals = [value(f.spans) for f in run.frames
            if f.index not in run.in_slice and getattr(f, "spans", None)]
    vals = [v for v in vals if v is not None]
    return 1e-6 * sum(vals) / len(vals) if vals else None


def _mapped(sl) -> tuple[Clock, list] | None:
    """The slice's clock and its span records, or None without them."""
    recs, anchors = getattr(sl, "spans", None), getattr(sl, "anchors", None)
    if not recs or not anchors:
        return None
    try:
        return Clock(anchors, sl.host), recs
    except ValueError:
        return None


def host_waits(sl) -> float | None:
    """Blocking runtime calls in slice ``sl`` inside a ``frame.*`` span,
    over the slice's frames; None without the card's runtime events or the
    spans."""
    m = _mapped(sl)
    runtime = [e for e in sl.host if e[1].startswith("cuda_")]  # the CUDA API's calls
    if m is None or not runtime or not sl.frames:
        return None
    clock, recs = m
    spans = sorted((clock(t0), clock(t1)) for _, p, n, t0, t1 in recs
                   if not p and n.startswith("frame."))
    starts = [s for s, _ in spans]
    n = 0
    for name, _, s, d in runtime:
        if is_blocking(name):
            k = bisect.bisect_right(starts, s) - 1
            n += k >= 0 and s < spans[k][1]
    return n / sl.frames


def _label(parent: str, name: str) -> str:
    return name if name.startswith(("kernel.", "stream.")) else (
        f"{parent}/{name}" if parent else name)


def innermost(recs, clock) -> list[tuple[float, float, str]]:
    """The host's timeline on the trace's clock: (start, end, the innermost
    open span's label), ``outside`` between spans; labels are
    ``kernel.<name>``, ``stream.<name>``, else the span's path."""
    evs = []
    for _, p, n, t0, t1 in recs:
        depth = p.count("/") + bool(p)
        evs.append((clock(t0), 1, depth, _label(p, n)))  # outer spans open first
        evs.append((clock(t1), 0, -depth, None))  # and close last
    evs.sort(key=lambda e: e[:3])
    out, stack, t = [], [], None
    for ts, opening, _, label in evs:
        if t is not None and ts > t:
            out.append((t, ts, stack[-1] if stack else "outside"))
        t = ts
        if opening:
            stack.append(label)
        elif stack:
            stack.pop()
    return out


def idle_by_span(sl, top: int = 10) -> list | None:
    """The slice's idle seconds (between the card's busy intervals) split
    by the innermost span open on the host at each instant: the ``top``
    labels with the most, ``outside`` where no span is open."""
    m = _mapped(sl)
    if m is None or not sl.device:
        return None
    clock, recs = m
    busy = sl.busy()
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    line = innermost(recs, clock)
    by: dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        covered = 0.0
        while j < len(line) and line[j][1] <= g0:
            j += 1
        k = j
        while k < len(line) and line[k][0] < g1:
            s, e, label = line[k]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                by[label] = by.get(label, 0.0) + ov * 1e-6
                covered += ov
            k += 1
        if g1 - g0 > covered:
            by["outside"] = by.get("outside", 0.0) + (g1 - g0 - covered) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


# --- the tool: a cell's program with the spans on, outside the benchmark ---


def _frames(kind, loop, n: int) -> list:
    """``n`` more frames of the cell's loop: the kind's own dispatch where
    it has one, else the closed loop at the mix's frames in flight."""
    stop = len(loop.frames) + n
    if hasattr(kind, "drive"):
        kind.drive(loop, lambda: len(loop.frames) >= stop)
    else:
        while len(loop.frames) < stop:
            loop.step(kind.traffic["in_flight"])
        loop.drain(60.0)
    return loop.frames[stop - n:stop]


def _span_cost_ns(trace, on: bool, n: int = 200_000) -> float:
    trace.enable(on)
    try:
        t = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("x"):
                pass
        spent = time.perf_counter_ns() - t
    finally:
        trace.enable(False)
        trace.reset()
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    return (spent - (time.perf_counter_ns() - t)) / n


def _launch_match(events: list, clock: Clock, recs) -> dict:
    """Of the hand kernels' launches (device kernels outside PyTorch's
    ``at::`` namespaces, found by correlation id), the share whose runtime
    call lies inside a ``kernel.*`` span, and which kernels each span name
    launched."""
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})
               and "at::" not in e["name"]}
    spans = sorted((clock(t0), clock(t1), n) for _, _, n, t0, t1 in recs
                   if n.startswith("kernel."))
    starts = [s for s, _, _ in spans]
    inside, total, seen = 0, 0, {}
    from benchmark.trace import op_name

    for e in events:
        corr = e.get("args", {}).get("correlation")
        if not e.get("cat", "").startswith("cuda_") or corr not in kernels:
            continue
        total += 1
        t = float(e["ts"])
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0 and spans[k][1] < t:  # an enclosing span starts earlier
            k -= 1
        if k >= 0 and spans[k][0] <= t <= spans[k][1]:
            inside += 1
            seen.setdefault(spans[k][2], set()).add(op_name(kernels[corr]))
    return {"launches": total, "inside_share": inside / total if total else None,
            "by_span": {k: sorted(v) for k, v in sorted(seen.items())}}


def measure(cell: str, seed: int, frames: int = 1200, slice_frames: int = 256) -> dict:
    """The tool's readings for ``cell`` (above)."""
    import json
    import os
    import tempfile

    from benchmark import mix
    from benchmark import trace as bench_trace
    from benchmark.loop import Loop
    from benchmark.program import Program
    from benchmark.run import cell_parts, spec
    from tpu_inspect_torch.utils import trace

    _, cfg, traffic, _, _ = cell_parts(spec(), cell)
    dev = torch.device("cuda", 0)
    kind = mix.load(traffic)
    program = Program(cfg, dev)
    pool = kind.pool(cfg, seed, dev)
    kind.prepare(program, pool)
    loop = Loop(program, pool)
    _frames(kind, loop, 2 * len(pool))
    out = {"workload": cell, "seed": seed, "device": torch.cuda.get_device_name(dev),
           "span_off_ns": _span_cost_ns(trace, False), "span_on_ns": _span_cost_ns(trace, True)}

    # blocks of frames with the spans off and on in turn: the harness's
    # dispatch span (where the loop takes it) and, on, the frames' spans
    block = frames // 6
    disp = {False: [], True: []}
    per: dict[str, list] = {}
    for i in range(6):
        on = i % 2 == 1
        trace.reset()
        trace.enable(on)
        fs = _frames(kind, loop, block)
        trace.enable(False)
        disp[on] += [f.end - f.start for f in fs if f.end]
        if on:
            assign(fs, trace.records())
            for f in fs:
                for key, v in f.spans.items():
                    if key.endswith("_ns"):
                        per.setdefault(key[:-3], []).append(v)
    if disp[False] and disp[True]:
        out["dispatch_ms"] = {"off": 1e3 * float(np.mean(disp[False])),
                              "on": 1e3 * float(np.mean(disp[True]))}
    out["ms_per_frame"] = {k: 1e-6 * float(np.mean(v)) for k, v in per.items()}
    if "frame" in out["ms_per_frame"]:
        out["ms_per_frame"]["glue"] = out["ms_per_frame"]["frame"] - out["ms_per_frame"]["kernel"]

    # a slice of the card alone with the spans on, anchored at both ends
    torch.cuda.synchronize()
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        anchors = [anchor(), anchor()]  # the first often has a wide bracket
        trace.enable(True)
        _frames(kind, loop, slice_frames)
        trace.enable(False)
        anchors.append(anchor())
        wall = time.perf_counter() - t_start
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    sl = bench_trace.Slice(frames=slice_frames, wall_s=wall)
    sl.device = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0))) for e in events
                 if e.get("cat") in bench_trace._DEVICE_CATS]
    sl.host = [(e.get("name", ""), e.get("cat"), float(e["ts"]), float(e.get("dur", 0)))
               for e in events if e.get("cat") in bench_trace._HOST_CATS]
    sl.spans, sl.anchors = trace.records(), anchors
    trace.reset()
    clock = Clock(anchors, sl.host)
    out["clock"] = {"offset_us": clock.offset[0], "drift_us": clock.drift_us,
                    "error_us": clock.error_us, "anchors": len(clock.offset),
                    "dropped": clock.dropped, "slice_s": wall}
    out["runtime_events"] = sum(1 for e in sl.host if e[1] == "cuda_runtime")
    out["launch_match"] = _launch_match(events, clock, sl.spans)
    out["host_waits_per_frame"] = host_waits(sl)
    out["blocking_calls"] = sorted({e[0] for e in sl.host if is_blocking(e[0])})
    out["idle_share"] = 1.0 - sl.busy_s() / wall
    out["idle_by_span"] = idle_by_span(sl)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=1200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for cell in args.workload:
        print(json.dumps(measure(cell, args.seed, args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
