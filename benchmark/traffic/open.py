"""Open loop: frames fall due on a fixed schedule and each is dispatched
then, or at once if the host is late; answers are collected, oldest
first, as their events report them done, without blocking a frame that
falls due.

Parameters: ``pool``; ``rate_per_s``, frame ``k`` falling due
``k / rate_per_s`` seconds into the window; ``in_flight``, for set-up's
warm-up only. Another schedule (bursts, say) is a kind that overrides
:meth:`Kind.due`.
"""

from benchmark.loop import clock
from benchmark.mix import Mix


class Kind(Mix):
    def due(self, k: int) -> float:
        """Seconds into the window at which frame ``k`` falls due."""
        return k / self.traffic["rate_per_s"]

    def run(self, loop, seconds):
        t0 = clock()
        t1 = t0 + seconds
        k = 0
        due = t0 + self.due(0)
        while due < t1:
            with loop.phase("bench.wait"):
                loop.collect_done()
                late = clock() >= due
            if late:
                loop.dispatch(due)
                k += 1
                due = t0 + self.due(k)
        return t0, t1
