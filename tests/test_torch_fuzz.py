"""The seeded fuzz of tests/test_engine_defect.py over the reference's
config cross-product (method x gaussian_blur x morph_kernel x adapt_block x
defect method x median_k x threshold x erode_px x min_area), through the
port's engine on the CPU (the kernels' plain versions), one test case per
trial of the same seeded sequence: exact against the oracle copy
(``tpu_inspect_torch.oracle``) and the JAX package's oracle on every trial,
and against the JAX engine itself on the first JAX_TRIALS trials. On the
others the JAX engine's equality with the JAX oracle on these very trials
is tests/test_engine_defect.py's fuzz; running the JAX engine here too
would compile a program per trial, about 6 s each with a cold cache."""

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng
from tpu_inspect import oracle as joracle

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import oracle as toracle

N_TRIALS = 10
JAX_TRIALS = 2


def _trials():
    """The crops and the trials' configurations, drawn in the order of
    tests/test_engine_defect.py:test_randomized_config_cross_product_fuzz."""
    rng = np.random.RandomState(20260821)
    crops = rng.randint(0, 256, (4, 48, 56), dtype=np.uint8)
    trials = []
    for _ in range(N_TRIALS):
        sp = tcfg.SegmentationParams(
            method=str(rng.choice(["otsu", "adaptive"])),
            gaussian_blur=int(rng.randint(0, 32)),
            morph_kernel=int(rng.randint(0, 32)),
            adapt_block=int(rng.randint(3, 202)),
            adapt_C=int(rng.randint(-20, 21)),
        )
        dp = tcfg.DefectParams(
            method=str(rng.choice(["threshold", "canny"])),
            median_k=int(rng.choice([3, 5, 9, 21, 31])),
            threshold=int(rng.randint(0, 256)),
            erode_px=int(rng.randint(0, 14)),
            min_area=int(rng.randint(0, 60)),
        )
        trials.append((sp, dp))
    return crops, trials


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_randomized_config_cross_product_fuzz(trial):
    crops, trials = _trials()
    sp, dp = trials[trial]
    label = f"trial {trial}: {sp} {dp}"
    seg = teng.segment_units(crops, sp, device="cpu")
    for oracle, cfg in ((toracle, lambda c: c), (joracle, _j)):
        ref_masks, _, _ = oracle.segment_all_units(crops, cfg(sp))
        np.testing.assert_array_equal(seg.masks, ref_masks, err_msg=f"{label} {oracle.__name__}")

    insp = teng.detect_defects_batch(crops, seg.masks, dp, device="cpu")
    for oracle, cfg in ((toracle, lambda c: c), (joracle, _j)):
        ref_dms, ref_areas, ref_verdicts = oracle.inspect_units(crops, seg.masks, cfg(dp))
        lab = f"{label} {oracle.__name__}"
        for i, dm in enumerate(ref_dms):
            assert bool(insp.valid[i]) == (dm is not None), f"{lab} unit {i}: detection"
            if dm is not None:
                np.testing.assert_array_equal(insp.defect_masks[i], dm, err_msg=f"{lab} unit {i}")
        np.testing.assert_array_equal(insp.areas, ref_areas, err_msg=lab)
        np.testing.assert_array_equal(insp.verdicts, ref_verdicts, err_msg=lab)
    if trial < JAX_TRIALS:
        jseg = jeng.segment_units(crops, _j(sp))
        np.testing.assert_array_equal(seg.masks, jseg.masks, err_msg=label)
        jinsp = jeng.detect_defects_batch(crops, jseg.masks, _j(dp))
        for f in ("defect_masks", "valid", "areas", "verdicts"):
            np.testing.assert_array_equal(getattr(insp, f), getattr(jinsp, f), err_msg=label)
