"""The seeded differential fuzz tool (``tpu_inspect_torch.tools.fuzz_parity``)
on the CPU.

Its generator is deterministic for a seed, and within chip_smoke.py's fuzz
phase (``SMOKE_SEED``, ``SMOKE_TRIALS``) it reaches every class and both
sides of every route gate. A few small trials of each class run through
``device="cpu"`` against the oracle copy; two of them also against the
JAX engine. The pinned Otsu tie (one 7x2 unit, otsu, ``gaussian_blur``
27), where OpenCV 5's scan takes another of two near-equal thresholds than
OpenCV 4's recurrence (which the JAX package and the port reproduce), is
classified as a tie and no other oracle difference passes. Runs on the card
are chip_smoke.py's phase and the tool's own command line.
"""

import numpy as np
import pytest
import torch

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.config import DefectParams, SegmentationParams
from tpu_inspect_torch.tools import fuzz_parity as fp

CPU = torch.device("cpu")
# the Otsu tie: the blurred unit's two best thresholds' variances differ
# in the 14th digit (OpenCV 4.x's scan and the port take the larger)
TIE_UNIT = np.array([[65, 23], [200, 128], [87, 37], [111, 191], [154, 217], [89, 134],
                     [216, 247]], np.uint8)
TIE_SEG = SegmentationParams(method="otsu", gaussian_blur=27)


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


def test_generator_is_deterministic_and_printable():
    a = fp.trials(14, 30)
    assert [t.line() for t in a] == [t.line() for t in fp.trials(14, 30)]
    assert [t.line() for t in a] != [t.line() for t in fp.trials(15, 30)]
    assert all("\n" not in t.line() for t in a)
    # an index is the same trial whatever the class filter
    only = fp.trials(14, 3, classes=("whole",))
    assert [t.line() for t in only] == [t.line() for t in a if t.cls == "whole"][:3]
    assert fp.trials(14, 1, start=7)[0].line() == a[7].line()


@pytest.mark.parametrize("method", ["otsu", "adaptive"])
@pytest.mark.parametrize("blur", [0, 1, 2, 3, 31])
def test_route_launches_count_the_head_kernels(method, blur):
    """Kernel M once on every seg route where ``as_odd(gaussian_blur) > 1``
    (blur 1 rounds to a 1-tap window: no launch), Otsu twice for otsu and
    kernel N once for adaptive; no defect or preview route runs the head;
    the sharded segment pass needs the same kernels on every rank."""
    seg = SegmentationParams(method=method, gaussian_blur=blur)
    dp = DefectParams()
    m = int(blur >= 2)
    head = {"gauss_blur": m, "otsu": 2 * (method == "otsu"), "adaptive": int(method == "adaptive")}
    routes = ("split seg", "whole seg") + (("chained",) if method == "otsu" else ())
    for route in routes:
        got = fp.route_launches(route, seg, dp)
        assert {k: got[k] for k in head} == head, route
    for route in ("split defect", "whole defect", "diag", "outline", "largest"):
        got = fp.route_launches(route, seg, dp)
        assert not any(got[k] for k in head), route
    assert set(fp.head_launches(seg)) == {k for k, v in head.items() if v}
    assert {"gauss_blur", "adaptive"} <= set(fp.USER_KERNELS)


def test_smoke_phase_reaches_every_class_and_gate_side():
    ts = fp.trials(fp.SMOKE_SEED, fp.SMOKE_TRIALS)
    assert {t.cls for t in ts} == set(fp.CLASSES)
    sides = set().union(*(fp.gate_sides(t) for t in ts))
    assert sides >= {"A shared", "A scratch", "C shared", "C scratch", "K shared", "K scratch",
                     "B", "H", "unit route", "whole route", "whole route by the int32 gate",
                     "morph odd", "morph even", "erode > 100"}
    assert any(t.cls == "whole" and t.h * t.w > 2**20 for t in ts)  # at the real gate
    assert any(t.cls == "preview" and t.u > 8 for t in ts)  # J's cluster below 16


@pytest.mark.parametrize("cls", fp.CLASSES)
def test_small_trials_pass_on_cpu(cls):
    n = 1 if cls == "sharded" else 2
    for t in fp.trials(fp.SMOKE_SEED, n, classes=(cls,), small=True):
        fp.run_trial(t, CPU)


def test_trials_match_the_jax_engine():
    # the first two otsu trials of the units class (one Canny, one
    # threshold): an adaptive block near 150 takes the JAX program about
    # 10 s to compile on the CPU
    ts = [t for t in fp.trials(fp.SMOKE_SEED, 6, classes=("units",), small=True)
          if t.seg.method == "otsu"][:2]
    assert len(ts) == 2 and {t.dp.method for t in ts} == {"canny", "threshold"}
    for t in ts:
        crops = fp.unit_crops(t)
        seg, insp = teng.inspect_units(crops, t.seg, t.dp, device="cpu")
        jseg, jinsp = jeng.inspect_units(crops, _j(t.seg.validated()), _j(t.dp.validated()))
        for f in ("masks", "centroids", "centroid_valid", "shifts"):
            np.testing.assert_array_equal(getattr(seg, f), getattr(jseg, f), err_msg=t.line())
        for f in ("defect_masks", "valid", "areas", "verdicts"):
            np.testing.assert_array_equal(getattr(insp, f), getattr(jinsp, f), err_msg=t.line())


def test_pinned_otsu_tie_is_classified():
    import cv2

    crops = TIE_UNIT[None]
    port = teng.segment_units(crops, TIE_SEG, device="cpu").masks
    jax_masks = jeng.segment_units(crops, _j(TIE_SEG.validated())).masks
    np.testing.assert_array_equal(port, jax_masks)
    assert fp.otsu_tie_units(crops, TIE_SEG).tolist() == [True]
    t = fp.Trial(0, 0, "units", 1, 7, 2, TIE_SEG, DefectParams(), 0)
    out = fp.check_units(t, crops, "cpu")
    blurred = cv2.GaussianBlur(TIE_UNIT, (27, 27), 0)
    _, cv_mask = cv2.threshold(blurred, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    oracle_differs = not np.array_equal(cv_mask, port[0])  # OpenCV 5 does; 4.x does not
    assert len(out.ties) == int(oracle_differs)


def test_other_oracle_differences_fail():
    rng = np.random.RandomState(3)
    crops = rng.randint(0, 256, (2, 9, 11)).astype(np.uint8)
    assert not fp.otsu_tie_units(crops, SegmentationParams()).any()
    t = fp.Trial(0, 0, "units", 2, 9, 11, SegmentationParams(), DefectParams(), 0)
    r = fp._Runner(t, CPU)
    got = {"masks": np.zeros((2, 9, 11), np.uint8)}
    want = {"masks": got["masks"].copy()}
    want["masks"][1, 4, 5] = 255
    with pytest.raises(fp.TrialFailure, match="cpu vs oracle.*unit 1 pixel \\(4, 5\\)"):
        r.vs_oracle("inspect_units", got, want, crops, ("masks",))
    r.vs_oracle("inspect_units", got, {"masks": got["masks"].copy()}, crops, ("masks",))


def test_cli_runs_on_cpu_and_refuses_a_missing_card():
    assert fp.main(["--device", "cpu", "--trials", "4", "--seed", "14", "--small"]) == 0
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fp.main(["--device", "cuda", "--trials", "1"])
