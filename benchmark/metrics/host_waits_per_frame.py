"""Host waits for the card a frame inside the one-capture program: in the
trace's device slice, the blocking runtime calls (a synchronize of the
device, a stream or an event, or a copy without Async) that fall inside a
``frame.*`` span put on the trace's clock (``benchmark.spans``), over the
slice's frames. None without the card's runtime events or the spans."""

from benchmark.spans import host_waits


def read(run):
    s = run.slices.get("device")
    return host_waits(s) if s else None
