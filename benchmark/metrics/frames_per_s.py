"""Frames whose verdicts, areas and found flags reached the host inside
the window, unrefused, over the window's seconds."""


def read(run):
    return run.answered_before(run.t1) / run.seconds
