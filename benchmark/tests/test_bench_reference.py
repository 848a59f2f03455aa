"""The plain reference against OpenCV itself (where cv2 is installed): a
seeded capture's units through the whole chain, and the contour rule on
random masks."""

import numpy as np
import pytest
import torch

from benchmark import frames
from benchmark.reference import chain
from benchmark.reference import components as cc
from conftest import small

cv2 = pytest.importorskip("cv2")


def _oracle(crops, cfg):
    """The tool's chain as its cv2 calls (segmentation.py, indexing_ui.py)."""
    sp, dp = cfg["segmentation"], cfg["defect"]
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (sp["morph_kernel"],) * 2)
    seg, dm = [], []
    for g in crops:
        b = cv2.GaussianBlur(g, (sp["gaussian_blur"] | 1,) * 2, 0)
        if sp["method"] == "adaptive":
            m = cv2.adaptiveThreshold(b, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                      cv2.THRESH_BINARY_INV, sp["adapt_block"] | 1, sp["adapt_C"])
        else:
            _, m = cv2.threshold(b, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
        m = cv2.morphologyEx(cv2.morphologyEx(m, cv2.MORPH_CLOSE, se), cv2.MORPH_OPEN, se)
        pad = cv2.copyMakeBorder(255 - m, 1, 1, 1, 1, cv2.BORDER_CONSTANT, value=255)
        cv2.floodFill(pad, np.zeros((pad.shape[0] + 2, pad.shape[1] + 2), np.uint8), (0, 0), 0)
        m = m | pad[1:-1, 1:-1]
        for e in cfg["exclusions"]:
            yy, xx = np.ogrid[:m.shape[0], :m.shape[1]]
            m[(xx - e["cx"]) ** 2 + (yy - e["cy"]) ** 2 <= e["r"] ** 2] = 0
        seg.append(m)
        roi = cv2.erode(m, None, iterations=dp["erode_px"])
        n, lab, st, _ = cv2.connectedComponentsWithStats((roi > 0).astype(np.uint8), connectivity=8)
        if n > 1:
            roi = ((lab == 1 + int(np.argmax(st[1:, cv2.CC_STAT_AREA]))) * 255).astype(np.uint8)
        if dp["method"] == "canny":
            c = cv2.Canny(g, max(1, dp["threshold"] // 2), max(2, dp["threshold"])) & roi
        else:
            _, c = cv2.threshold(cv2.absdiff(g, cv2.medianBlur(g, dp["median_k"] | 1)),
                                 dp["threshold"], 255, cv2.THRESH_BINARY)
            c = cv2.morphologyEx(c & roi, cv2.MORPH_OPEN,
                                 cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3)))
        cnts, _ = cv2.findContours(c, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        cap = max(dp["min_area"], int(int((roi > 0).sum()) * dp["max_area_frac"]))
        out = np.zeros_like(c)
        for k in cnts:
            if dp["min_area"] <= cv2.contourArea(k) <= cap:
                cv2.drawContours(out, [k], -1, 255, -1)
        dm.append(out)
    return np.stack(seg) > 0, np.stack(dm) > 0


@pytest.mark.parametrize("name", ["grid48-otsu-threshold", "grid48-adaptive-canny"])
def test_chain_matches_opencv(name):
    cfg = small(name)
    cfg["capture"]["defect_rate"] = 0.9
    img = frames.make_frame(cfg, (0, 0), frames.generator(11, "cpu"))
    x = chain.crops(img, cfg["grid"])
    seg, dm = _oracle(x.numpy(), cfg)
    got = chain.inspect(img, cfg)
    assert np.array_equal(got["seg_mask"], seg)
    assert np.array_equal(got["defect_mask"], dm)
    assert np.array_equal(got["area"], dm.sum(axis=(1, 2)))


@pytest.mark.parametrize("seed", range(8))
def test_contour_rule_matches_opencv(seed):
    rng = np.random.RandomState(seed)
    m = (rng.rand(20, 23) < rng.uniform(0.2, 0.8)).astype(np.uint8) * 255
    cnts, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    fill = ~cc.exterior(torch.from_numpy(m > 0)[None])
    reg = cc.components(fill, conn8=True)
    n = torch.bincount(reg.reshape(-1))
    p = torch.bincount(reg.reshape(-1), weights=cc.contour_visits(fill).reshape(-1).double())
    roots = [r for r in torch.unique(reg).tolist() if r]
    area2 = sorted(0 if n[r] == 1 else int(2 * n[r] - p[r] - 2) for r in roots)
    assert area2 == sorted(int(round(2 * cv2.contourArea(c))) for c in cnts)
    paint = np.zeros_like(m)
    cv2.drawContours(paint, cnts, -1, 255, -1)
    assert np.array_equal(paint > 0, fill[0].numpy())
