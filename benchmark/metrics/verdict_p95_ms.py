"""The 95th percentile, over every frame due in the window, of the
milliseconds from when it fell due to its answers on the host; a frame
refused (its bound flag set) or never answered counts as infinitely
late (a run where over 5% are reads no percentile)."""

import math

from benchmark.loop import p95


def read(run):
    lat = [(f.done - f.due) * 1e3 if f.answers is not None and int(f.answers[0][0]) == 0
           else math.inf for f in run.frames]
    v = p95(lat) if lat else math.inf
    return None if math.isinf(v) else v
