"""Device operations (kernels, copies, sets) a frame costs, in the device
slice: each frame's work ends with the copies of its four answers (flag,
verdicts, areas, found flags: four device-to-host copies in a row), so
the operations between the first such run of copies and the last, over
the frames between them, count whole frames only."""

RUN = 4  # the answers' copies that close a frame


def read(run):
    s = run.slices.get("device")
    if not s:
        return None
    ops = sorted(s.device, key=lambda e: e[1])
    d2h = [n.startswith("Memcpy DtoH") for n, _, _ in ops]
    ends = [i + RUN - 1 for i in range(len(ops) - RUN + 1)
            if all(d2h[i:i + RUN]) and (i == 0 or not d2h[i - 1])]
    if len(ends) < 2:
        return None
    return (ends[-1] - ends[0]) / (len(ends) - 1)
