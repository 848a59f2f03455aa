"""Host milliseconds a frame in the stream's fetch: the ``stream.fetch``
span (the bound flag's check and the blocking copies of the verdicts,
areas and found flags, which wait for the card to finish the frame),
averaged over the window's frames outside the traced slices
(``benchmark.spans``). None where the run took no spans."""

from benchmark.spans import frame_mean_ms


def read(run):
    return frame_mean_ms(run, lambda s: s.get("fetch_ns"))
