"""The kernel rig ``tpu_inspect_torch.tools.kernel_bench`` on the CPU, at
its small size: every form of kernels B, C, D, E, F, G, H, I, J, M, N, O
and the Otsu kernel (and the launch floor) builds its planes through the port's engine, equals
its plain version exactly and gets a time (a host wall here, labelled so;
device times come from the card)."""

import json

import pytest

from tpu_inspect_torch.tools import kernel_bench


def test_kernel_bench_small_cpu(capsys):
    rows = kernel_bench.main(["--device", "cpu", "--small", "--n", "1", "--reps", "1"])
    assert [r["form"] for r in rows] == list(kernel_bench.FORMS)
    # C's two forms (the threshold and the Canny method's defect tail) and
    # O's (the Canny head on the units and on the whole plane)
    assert {"C 48u threshold form", "C 48u canny form", "O canny head 48u",
            "O canny head whole"} <= {r["form"] for r in rows}
    # M's and N's forms: each time of their rows in PERF.md has one
    assert [f for f in kernel_bench.FORMS if f[:2] in ("M ", "N ")] == [
        "M 48u k3", "M whole k3", "M 48u k31", "N 48u block51", "N 48u block201",
        "N whole block51"]
    # the Otsu kernel's: the threshold, the histogram and the scan apart,
    # the scan also on one unit; the histogram beside its bincount
    assert [f for f in kernel_bench.FORMS if f.startswith("Otsu ")] == [
        "Otsu 48u", "Otsu whole", "Otsu hist 48u", "Otsu hist whole", "Otsu scan 48u",
        "Otsu scan 1u"]
    kernel = {r["form"]: r["kernel"] for r in rows}
    assert kernel["Otsu 48u"] == "otsu" and kernel["Otsu hist whole"] == "otsu_hist"
    assert kernel["Otsu scan 1u"] == "otsu_scan"
    library = {r["form"]: r["library_ms"] for r in rows}
    assert sorted(f for f, ms in library.items() if ms is not None) == [
        "Otsu hist 48u", "Otsu hist whole"]
    assert all(library[f] > 0 for f in kernel_bench.LIBRARY)
    assert kernel["C 48u canny form"] == "blob_filter"
    assert kernel["M 48u k31"] == "gauss_blur" and kernel["N whole block51"] == "adaptive"
    assert kernel["O canny head whole"] == "canny_head"
    for r in rows:
        assert r["max_abs_err"] == 0 and r["where"] == "cpu (host wall)"
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["bound_ms"] > 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rows
    # the small planes' shapes, the launch floor's one byte, and the Otsu
    # forms' thresholds and histograms
    assert {tuple(r["shape"]) for r in rows} == {(4, 64, 64), (1, 64, 64), (1, 96, 128),
                                                 (1, 1, 1), (4,), (1,), (4, 256), (1, 256)}


def test_kernel_bench_rejects_unknown_form():
    with pytest.raises(ValueError, match="unknown forms"):
        kernel_bench.bench(("no such form",), device="cpu", small=True)
