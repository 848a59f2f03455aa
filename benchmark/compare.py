"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark.reference``) run on the same
captures once the window has closed.

Each number counts disagreements, so each limit is 0 (the tool's answers
are integers and bit-exact is the guarantee):

- ``seg_px``, ``defect_px``: pixels of the seg masks and defect masks of
  each pool capture's last pass in the window that differ from the
  reference's;
- ``shift_units``: units whose exclusion shift (dx, dy) differs;
- ``area_units``, ``found_units``, ``verdict_units``: over every frame
  answered, units whose defect area, found flag or verdict differs from
  the reference's for its capture;
- ``unanswered``: frames due whose answers never came, or came with the
  bound flag set (the program refused them).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import chain

LIMITS = {
    "seg_px": 0, "shift_units": 0, "defect_px": 0, "area_units": 0,
    "found_units": 0, "verdict_units": 0, "unanswered": 0,
}


def reference_answers(pool, cfg: dict, anchored: bool, low: bool = False) -> list[dict]:
    """The reference's results for each capture of ``pool`` (the first the
    reference capture when ``anchored``): host arrays (:func:`chain.inspect`,
    ``low`` as there)."""
    anchors = None
    if anchored:
        first = chain.inspect(pool[0], cfg, None, low)
        anchors = (first["centroid"], first["has_fg"])
    return [chain.inspect(img, cfg, anchors, low) for img in pool]


def count(frames, last: dict[int, dict], ref: list[dict]) -> dict:
    """The numbers compared. ``frames``: the window's
    :class:`benchmark.loop.Frame` records; ``last``: pool capture -> host
    arrays of its last pass (``seg_mask``, ``shift``, ``defect_mask``);
    ``ref``: :func:`reference_answers`."""
    n = dict.fromkeys(LIMITS, 0)
    for p, got in last.items():
        r = ref[p]
        n["seg_px"] += int(((got["seg_mask"] > 0) != r["seg_mask"]).sum())
        n["shift_units"] += int((got["shift"] != r["shift"]).any(axis=1).sum())
        n["defect_px"] += int(((got["defect_mask"] > 0) != r["defect_mask"]).sum())
    for f in frames:
        if f.answers is None or int(f.answers[0][0]) != 0:
            n["unanswered"] += 1
            continue
        _, verdict, area, found = f.answers
        r = ref[f.pool]
        n["area_units"] += int((area.astype(np.int64) != r["area"]).sum())
        n["found_units"] += int((found != r["found"]).sum())
        n["verdict_units"] += int((verdict != r["verdict"]).sum())
    return n


def checks(numbers: dict) -> dict:
    """Each number beside its limit, for the result line."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def passed(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
