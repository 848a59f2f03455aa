"""Closed loop on moving molds: captures 1 to ``pool`` - 1 are shifted by
a seeded whole number of pixels in [-``shift_px``, ``shift_px``] on each
axis, as a mold that moved between captures. Capture 0 is the reference
capture: set-up takes its centroids as the anchors of every frame, so
each frame runs the exclusion alignment (the reference does the same).
Parameters: those of ``closed``, and ``shift_px``."""

from benchmark import frames
from benchmark.mix import kind


class Kind(kind("closed")):
    anchored = True

    def pool(self, cfg, seed, device):
        return frames.make_pool(cfg, self.traffic["pool"], seed, device,
                                self.traffic["shift_px"])[0]

    def prepare(self, program, pool):
        program.set_reference(pool[0])
