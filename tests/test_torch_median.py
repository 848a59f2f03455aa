"""Kernel B (tpu_inspect_torch.ops.median.median_residual_mask) vs the
Pallas median-residual kernel.

The port's plain version (the CPU path) is held bit-exact against
``tpu_inspect.ops.median_pallas.median_residual_mask_pallas`` in Pallas
interpret mode on the rows each unit processes ([row_lo, row_hi): the TPU
kernel leaves other rows unwritten, the port writes 0 there), and against
cv2's medianBlur residual through the JAX package's plain path on whole
planes.
"""

import importlib
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_inspect.ops import median as jmedian
from tpu_inspect.ops import threshold as jthr

from tpu_inspect_torch.ops.median import median_residual_mask, median_residual_mask_plain
from tpu_inspect_torch.tools.median_probe import MODES, STRIPS, probe

_ORIG_PALLAS_CALL = pl.pallas_call


def _interpreted(*args, **kwargs):
    kwargs.setdefault("interpret", True)
    return _ORIG_PALLAS_CALL(*args, **kwargs)


@pytest.fixture(scope="module")
def mp():
    """tpu_inspect.ops.median_pallas reloaded with pallas_call interpreted."""
    with mock.patch.object(pl, "pallas_call", _interpreted):
        import tpu_inspect.ops.median_pallas as mod

        importlib.reload(mod)
        yield mod
    importlib.reload(mod)


@pytest.mark.parametrize("k,thr,variant", [(3, 255, "base"), (9, 24, "cdfx"), (21, 0, "base")])
def test_roi_rows_match_pallas(mp, k, thr, variant):
    rng = np.random.RandomState(k)
    u, h, w = 4, 30, 40
    x = rng.randint(0, 256, (u, h, w), dtype=np.uint8)
    x[2] = 128  # flat unit: residual 0 everywhere
    lo = np.array([0, 5, 12, 30], np.int32)  # unit 3: empty row range
    hi = np.array([30, 20, 13, 0], np.int32)
    ref = np.asarray(mp.median_residual_mask_pallas(
        jnp.asarray(x), k, thr, row_lo=jnp.asarray(lo), row_hi=jnp.asarray(hi),
        variant=variant,
    ))
    got = median_residual_mask(
        torch.from_numpy(x), k, thr, torch.from_numpy(lo), torch.from_numpy(hi)
    ).numpy()
    for i in range(u):
        np.testing.assert_array_equal(
            got[i, lo[i]:hi[i]], ref[i, lo[i]:hi[i]], err_msg=f"unit {i}"
        )
        rows = np.ones(h, bool)
        rows[lo[i]:hi[i]] = False
        assert not got[i, rows].any(), "rows outside [row_lo, row_hi) must be 0"


@pytest.mark.parametrize("k,thr", [(5, 10), (21, 24)])
def test_whole_plane_matches_reference_median(k, thr):
    """Against the JAX package's plain medianBlur + absdiff + THRESH_BINARY
    (cv2 parity), including planes narrower than the window."""
    rng = np.random.RandomState(100 + k)
    for shape in [(3, 23, 29), (2, 7, 11)]:
        x = rng.randint(0, 256, shape, dtype=np.uint8)
        bg = jmedian.median_blur_u8(jnp.asarray(x), k)
        resid = jnp.abs(jnp.asarray(x).astype(jnp.int32) - bg.astype(jnp.int32))
        ref = np.asarray(jthr.threshold_binary(resid, thr))
        got = median_residual_mask_plain(torch.from_numpy(x), k, thr).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"shape {shape}")



@pytest.mark.parametrize("strip", STRIPS)
def test_median_probe_baseline_and_ablations(strip):
    """The median-probe tool (kernel L): its baseline on the CPU is kernel
    B's plain version, equal to the JAX package's medianBlur residual on
    the ROI rows; its ablations, wrong by construction, refuse the CPU."""
    rng = np.random.RandomState(31)
    x = rng.randint(0, 256, (3, 23, 29), dtype=np.uint8)
    lo = np.array([0, 4, 23], np.int32)
    hi = np.array([23, 15, 0], np.int32)
    bg = jmedian.median_blur_u8(jnp.asarray(x), 21)
    resid = jnp.abs(jnp.asarray(x).astype(jnp.int32) - bg.astype(jnp.int32))
    ref = np.asarray(jthr.threshold_binary(resid, 24))
    rows = np.arange(23)[None, :, None]
    ref = np.where((rows >= lo[:, None, None]) & (rows < hi[:, None, None]), ref, 0)
    xt, lo_t, hi_t = torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(hi)
    got = probe(xt, 21, 24, lo_t, hi_t, "baseline", strip).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.uint8))
    for mode in MODES[1:]:
        with pytest.raises(ValueError, match="ablation"):
            probe(xt, 21, 24, lo_t, hi_t, mode, strip)
    with pytest.raises(ValueError, match="strip"):
        probe(xt, 21, 24, lo_t, hi_t, "baseline", strip + 1)


def test_median_probe_modes_match_the_kernel():
    """The tool's MODES, whose index it passes to kernel L, name the
    kernel's modes in their order: csrc/median_hist.cuh's Mode enum and
    the instantiation csrc/median_probe.cu launches for each index. A
    mismatch would time one ablation under another's name."""
    csrc = Path(probe.__code__.co_filename).resolve().parents[1] / "csrc"
    enum = re.search(r"enum Mode \{([^}]*)\}", (csrc / "median_hist.cuh").read_text())
    names = [n.strip().split("=")[0].strip() for n in enum.group(1).split(",")]
    assert tuple(n[1:].lower() for n in names) == MODES
    cases = re.findall(r"case (\d+): return launch<mh::(\w+)>",
                       (csrc / "median_probe.cu").read_text())
    assert cases == [(str(i), n) for i, n in enumerate(names)]
