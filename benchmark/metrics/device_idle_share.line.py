"""The card's idle share under the open loop, in the trace's device
slice: 1 - the device's busy seconds (the union of its operations'
intervals) over the slice's wall seconds. Tracing adds host time to each
dispatch, so where the host sets the pace the card idles longer in the
slice than untraced; the run prints the untraced estimate beside it
(``idle_at_untraced_rate``, on the line before the result)."""


def read(run):
    s = run.slices.get("device")
    if not s or not s.device or s.wall_s <= 0:
        return None
    return 1.0 - s.busy_s() / s.wall_s
