"""Closed loop: the pool's captures in turn, each frame dispatched as soon
as fewer than ``in_flight`` frames are in flight; the oldest frame's
answers are awaited first. Parameters: ``pool``, ``in_flight``."""

from benchmark.loop import clock
from benchmark.mix import Mix


class Kind(Mix):
    def run(self, loop, seconds):
        t0 = clock()
        t1 = t0 + seconds
        n = self.traffic["in_flight"]
        while clock() < t1:
            loop.step(n)
        return t0, t1
