"""The Otsu threshold: the port's against the JAX package's on the CPU, and
the CUDA kernel (``csrc/otsu.cu``) against its plain version on a GPU.

On the CPU also the kernel's two host-visible designs: the histogram's
grid (``hist_plan``: every pixel of every unit in exactly one CTA's chunk,
at least two CTAs a SM), and a numpy model of the scan's split (the q1
chain, then the mu1 chain, then every step's variance side by side and the
kernel's first-maximum reduction) against the plain scan.

The cases are seeded numpy units that reach every branch of OpenCV's
getThreshVal_Otsu_8u recurrence: random units, constant units (threshold
0: every step is guarded), two-level units, a unit whose one-pixel class
has a weight above 0 but under FLT_EPSILON (the guard that skips the
update), a three-level unit whose two splits tie (the strict '>' keeps the
first), one unit alone and odd unit sizes. The JAX package is imported inside the CPU
test only, so the ``cuda`` test runs on a machine without JAX:

    python -m pytest tests/test_torch_otsu.py -q --noconftest -m cuda

Tolerance is exact equality: a threshold is an integer, and both sides
run the same float64 operations in the same order.
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
from tpu_inspect_torch.ops.threshold import (
    hist_plan,
    histogram_u8,
    histogram_u8_plain,
    otsu_threshold,
    otsu_threshold_from_hist_plain,
    otsu_threshold_plain,
)
from tpu_inspect_torch.synthetic import standard_workload


def _cases():
    """(label, [U, H, W] uint8) pairs, drawn from one seed."""
    rng = np.random.RandomState(2024)
    out = [("random", rng.randint(0, 256, (5, 23, 31), dtype=np.uint8))]
    const = np.empty((4, 17, 19), np.uint8)
    for i, v in enumerate((0, 77, 128, 255)):
        const[i] = v
    out.append(("constant", const))
    two = np.where(rng.rand(3, 24, 31) > 0.5, 40, 200).astype(np.uint8)
    two[1] = np.where(rng.rand(24, 31) > 0.9, 3, 250)
    two[2] = np.where(rng.rand(24, 31) > 0.5, 0, 255)
    out.append(("two-level", two))
    # one outlier among 10^4 pixels: q1 = 1e-4 is above FLT_EPSILON; a
    # one-pixel class under it needs a unit of 2^23 px or more
    # (:func:`_guard_unit`)
    eps = np.full((2, 100, 100), 90, np.uint8)
    eps[0, 0, 0] = 10
    eps[1, 50, 50] = 250
    out.append(("outlier", eps))
    # ties: three equal levels, split {10} | {20, 30} or {10, 20} | {30}
    tie = np.zeros((2, 12, 12), np.uint8)
    tie[0].reshape(-1)[:48] = 10
    tie[0].reshape(-1)[48:96] = 20
    tie[0].reshape(-1)[96:] = 30
    tie[1].reshape(-1)[:72] = 100
    tie[1].reshape(-1)[72:] = 101
    out.append(("tie", tie))
    out.append(("one unit", rng.randint(30, 220, (1, 9, 7), dtype=np.uint8)))
    out.append(("odd sizes", rng.randint(0, 256, (3, 1, 1), dtype=np.uint8)))
    out.append(("odd sizes 2", rng.randint(0, 256, (2, 7, 3), dtype=np.uint8)))
    out.append(("narrow", rng.randint(100, 104, (3, 33, 65), dtype=np.uint8)))
    return out


def _guard_unit():
    """A 1x2900x2900 unit with one dark pixel: after bin 0 the class weight
    q1 = 1 / 8410000 is above 0 but under FLT_EPSILON, so the guard skips
    that step."""
    x = np.full((1, 2900, 2900), 200, np.uint8)
    x[0, 7, 9] = 0
    return x


@pytest.mark.parametrize("label,x", _cases(), ids=[c[0] for c in _cases()])
def test_otsu_matches_jax_package(label, x):
    import jax.numpy as jnp

    from tpu_inspect.ops import threshold as jthr

    t = torch.from_numpy(x)
    hist = histogram_u8(t)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jthr.histogram_u8(jnp.asarray(x))))
    got = otsu_threshold(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jthr.otsu_threshold(jnp.asarray(x))), label)
    assert got.dtype == np.int32
    if label == "constant":
        assert (got == 0).all(), "every step of a constant unit is guarded"
    if label == "tie":
        assert got[0] == 10, "the first of two equal maxima"


def test_otsu_guard_unit_matches_jax_package():
    import jax.numpy as jnp

    from tpu_inspect.ops import threshold as jthr

    x = _guard_unit()
    got = otsu_threshold(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jthr.otsu_threshold(jnp.asarray(x))))


H100_SMS = 132


@pytest.mark.parametrize("hw", [1, 3, 17, 143, 99540, 999 * 1001, 12_288_000])
def test_hist_plan_covers_every_pixel_once(hw):
    """The histogram kernel's grid for every unit count from 1 to 140: CTA
    p of a unit counts pixels [p chunk, min(hw, (p + 1) chunk)), none empty,
    all of them together the unit once; chunk a multiple of 16 (every
    chunk keeps its unit's alignment); at least two CTAs a SM wherever the
    units hold that many chunks of 4096 pixels (the least a CTA takes)."""
    for sms in (H100_SMS, 16):
        for u in range(1, 141):
            chunk, per = hist_plan(u, hw, sms)
            assert chunk % 16 == 0 and chunk > 0 and per >= 1
            starts = np.arange(per, dtype=np.int64) * chunk
            ends = np.minimum(starts + chunk, hw)
            assert (ends > starts).all(), (u, hw, sms)  # no CTA is empty
            assert starts[0] == 0 and ends[-1] == hw and (starts[1:] == ends[:-1]).all()
            assert u * per >= min(2 * sms, u * -(-hw // 4096)), (u, hw, sms)
            assert u * per < 2**31
    # the two inputs of the main path: 48 units of 315x316 and one capture
    assert 48 * hist_plan(48, 315 * 316, H100_SMS)[1] >= 2 * H100_SMS
    assert hist_plan(1, 3000 * 4096, H100_SMS)[1] >= 2 * H100_SMS


_EPS = 1.1920928955078125e-07  # FLT_EPSILON


def _split_scan(hist: np.ndarray, n: int) -> np.ndarray:
    """A numpy model of the scan kernel's split, [U, 256] counts -> [U]
    thresholds: thread 0 runs the q1 chain (adds only), writes every
    step's q1 and finds the interval [i0, i1] of the steps the guard
    leaves (one interval: q1 never falls, q2 never rises), then the mu1
    chain alone over it; then every step's sigma side by side (numpy
    float64 element-wise, the same operations), -inf outside the interval;
    then the kernel's reduction: each warp of 32 of the 512 threads by
    shuffles (the larger sigma, the smaller step among equals), then the
    16 warps' results in order with a strict '>', and 0 where the best is
    not above 0. Every scalar step is a Python float (IEEE double, round to
    nearest)."""
    scale = 1.0 / float(n)
    bins = np.arange(256, dtype=np.float64)
    out = np.zeros(hist.shape[0], np.int32)
    for u, h in enumerate(hist.astype(np.int64)):
        p = h.astype(np.float64) * scale
        ip = bins * p
        mu = float((h * np.arange(256)).sum()) * scale
        q1s, guard = np.zeros(256), np.zeros(256, bool)
        q1 = 0.0
        for i in range(256):
            q1 = q1 + float(p[i])
            q2 = 1.0 - q1
            q1s[i], guard[i] = q1, min(q1, q2) < _EPS or max(q1, q2) > 1.0 - _EPS
        left = np.flatnonzero(~guard)
        i0, i1 = (int(left[0]), int(left[-1])) if left.size else (256, -1)
        assert not guard[i0 : i1 + 1].any(), "the guard leaves one interval"
        mu1s = np.zeros(256)
        mu1 = 0.0
        q1_old = float(q1s[i0 - 1]) if 0 < i0 < 256 else 0.0
        for i in range(i0, i1 + 1):
            mu1 = mu1 * q1_old
            mu1 = (mu1 + float(ip[i])) / float(q1s[i])
            mu1s[i] = mu1
            q1_old = float(q1s[i])
        with np.errstate(all="ignore"):
            q2s = 1.0 - q1s
            mu2 = (mu - q1s * mu1s) / q2s
            d = mu1s - mu2
            sig = q1s * q2s * d * d
        sigma = np.full(512, -np.inf)
        steps = np.arange(256)
        sigma[:256] = np.where((steps >= i0) & (steps <= i1), sig, -np.inf)
        arg = np.arange(512)
        for off in (16, 8, 4, 2, 1):
            s_old, a_old = sigma.copy(), arg.copy()
            for t in range(512):
                if (t & 31) + off < 32:
                    os_, oa = s_old[t + off], a_old[t + off]
                    if os_ > s_old[t] or (os_ == s_old[t] and oa < a_old[t]):
                        sigma[t], arg[t] = os_, oa
        best, at = sigma[0], arg[0]
        for w in range(1, 16):
            if sigma[32 * w] > best:
                best, at = sigma[32 * w], arg[32 * w]
        out[u] = at if best > 0 else 0
    return out


def _scan_cases():
    """(label, [U, 256] int64 counts, n) of one seed: random histograms
    (dense, sparse, a narrow grey range), constant units, two-level units,
    the guard unit's and the tie units' of :func:`_cases`."""
    rng = np.random.RandomState(18)
    dense = rng.randint(0, 5000, (6, 256)).astype(np.int64)
    sparse = np.where(rng.rand(6, 256) > 0.93, rng.randint(1, 10**6, (6, 256)), 0).astype(np.int64)
    narrow = np.zeros((4, 256), np.int64)
    for u in range(4):
        lo = rng.randint(0, 230)
        narrow[u, lo : lo + 20] = rng.randint(0, 3000, 20)
    const = np.zeros((4, 256), np.int64)
    const[np.arange(4), [0, 77, 128, 255]] = 99540
    two = np.zeros((4, 256), np.int64)
    two[np.arange(4), [0, 3, 40, 100]] = [5, 99000, 70000, 1]
    two[np.arange(4), [255, 250, 200, 101]] = [99535, 540, 29540, 99539]
    cases = [("dense", dense), ("sparse", sparse), ("narrow", narrow), ("constant", const),
             ("two-level", two)]
    out = [(f"{label} {u}", c[u : u + 1], int(c[u].sum()))
           for label, c in cases for u in range(c.shape[0]) if c[u].sum()]
    guard = _guard_unit()
    out.append(("guard unit", np.bincount(guard.reshape(-1), minlength=256)[None], guard.size))
    tie = dict(_cases())["tie"]
    out += [(f"tie {u}", np.bincount(tie[u].reshape(-1), minlength=256)[None], tie[u].size)
            for u in range(tie.shape[0])]
    return out


@pytest.mark.parametrize("label,hist,n", _scan_cases(), ids=[c[0] for c in _scan_cases()])
def test_split_scan_model_matches_plain(label, hist, n):
    """The scan kernel's split order (two carried chains on one thread, the
    variances side by side, the first-maximum reduction) gives the plain
    scan's threshold: the chains keep OpenCV's operations in order, and the
    reduction keeps its first maximum."""
    want = otsu_threshold_from_hist_plain(torch.from_numpy(hist), n).numpy()
    np.testing.assert_array_equal(_split_scan(hist, n), want, label)
    if label.startswith("constant"):
        assert (want == 0).all()
    if label == "tie 0":
        assert want[0] == 10, "the first of two equal maxima"


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Otsu kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_otsu_kernel_matches_plain(cuda):
    wl = standard_workload()
    crops = gather_crops(
        torch.from_numpy(wl["image"]).to(cuda), torch.from_numpy(wl["origins"]).to(cuda),
        wl["unit_hw"],
    )
    whole = torch.from_numpy(wl["image"]).to(cuda)[None].contiguous()
    planes = [(label, torch.from_numpy(x).to(cuda)) for label, x in _cases()]
    blurred = gaussian_blur_u8(crops, 3).contiguous()
    rng = np.random.RandomState(18)
    planes += [
        ("guard", torch.from_numpy(_guard_unit()).to(cuda)),
        ("48 blurred crops", blurred),
        ("whole 3000x4096", whole),
        # units of 999 x 1001 px: every unit after the first starts off a
        # 4-byte boundary (the histogram's byte path)
        ("unaligned units", whole.reshape(-1)[: 3 * 999 * 1001].reshape(3, 999, 1001)),
        # one grey level and two, at the workload's unit size
        ("one level", torch.full((2, 315, 316), 91, dtype=torch.uint8, device=cuda)),
        ("two levels", torch.where(blurred > 120, 200, 30).to(torch.uint8)),
        # one pixel; 140 units of 143 px (not a multiple of 16); 17-px units
        ("1x1x1", torch.from_numpy(rng.randint(0, 256, (1, 1, 1), dtype=np.uint8)).to(cuda)),
        ("140 units", torch.from_numpy(rng.randint(0, 256, (140, 13, 11), dtype=np.uint8)).to(cuda)),
        ("hw 17", torch.from_numpy(rng.randint(0, 3, (5, 1, 17), dtype=np.uint8)).to(cuda)),
        # a view whose base lies 5 bytes past a 16-byte boundary: every
        # chunk's first bytes go one by one
        ("base off 16 bytes", whole.reshape(-1)[5 : 5 + 2 * 315 * 316].reshape(2, 315, 316)),
    ]
    assert planes[-1][1].data_ptr() % 16 == 5
    for label, x in planes:
        reset_launches()
        hist = histogram_u8(x)
        thr = otsu_threshold(x)
        assert LAUNCHES["otsu"] == 3, label  # histogram, then histogram + scan
        torch.cuda.synchronize()
        assert thr.device == x.device and thr.dtype == torch.int32
        assert torch.equal(hist, histogram_u8_plain(x)), label
        assert torch.equal(thr, otsu_threshold_plain(x)), label
