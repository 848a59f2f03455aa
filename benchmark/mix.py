"""Traffic kinds. A mix is ``traffic/<name>.json``: parameters, one of
which names its ``kind``. A kind is ``traffic/<kind>.py``, found by that
name, whose ``Kind`` class makes the mix's pool of captures, readies the
program for it and runs the window's loop (when frames fall due). The
run (``benchmark.run``) and the loop (``benchmark.loop``) hold nothing of
one mix, so a mix of a new kind adds a file here and changes what no
other cell runs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark import frames

HERE = Path(__file__).resolve().parent
_KINDS: dict[str, type] = {}


def kind(name: str) -> type:
    """The ``Kind`` class of ``traffic/<name>.py``."""
    if name not in _KINDS:
        path = HERE / "traffic" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark.traffic.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KINDS[name] = mod.Kind
    return _KINDS[name]


def load(traffic: dict) -> Mix:
    """The mix ``traffic`` (a mix file's parameters) as its kind."""
    return kind(traffic["kind"])(traffic)


class Mix:
    """What the kinds share; each overrides what differs. Every mix has a
    ``pool`` of distinct captures and an ``in_flight`` for set-up's
    warm-up."""

    anchored = False  # every frame aligns its exclusions to capture 0's anchors

    def __init__(self, traffic: dict):
        self.traffic = traffic

    def pool(self, cfg: dict, seed: int, device) -> list:
        """The mix's captures, made on ``device`` from ``seed``."""
        return frames.make_pool(cfg, self.traffic["pool"], seed, device)[0]

    def prepare(self, program, pool: list) -> None:
        """What the program needs before the mix's first frame."""

    def warm(self, loop, n: int) -> None:
        """Set-up's ``n`` frames, ``in_flight`` at a time."""
        while len(loop.frames) < n:
            loop.step(self.traffic["in_flight"])

    def run(self, loop, seconds: float) -> tuple[float, float]:
        """The window: frames for ``seconds``; returns its (start, end) on
        the host's clock."""
        raise NotImplementedError
