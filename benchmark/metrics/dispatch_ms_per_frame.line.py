"""Host milliseconds to enqueue one frame: the benchmark's span around
each call into the one-capture program (and the copy of its answers),
nothing waited for, summed over the window's frames outside the traced
slices and divided by their count."""


def read(run):
    spans = [f.end - f.start for f in run.frames if f.index not in run.in_slice]
    return 1e3 * sum(spans) / len(spans) if spans else None
