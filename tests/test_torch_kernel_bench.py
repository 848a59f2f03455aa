"""The kernel rig ``tpu_inspect_torch.tools.kernel_bench`` on the CPU, at
its small size: every form of kernels B, C, D, E, F, G, H, I, J, M, N and O
(and the launch floor) builds its planes through the port's engine, equals
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
    kernel = {r["form"]: r["kernel"] for r in rows}
    assert kernel["C 48u canny form"] == "blob_filter"
    assert kernel["M 48u k31"] == "gauss_blur" and kernel["N whole block51"] == "adaptive"
    assert kernel["O canny head whole"] == "canny_head"
    for r in rows:
        assert r["max_abs_err"] == 0 and r["where"] == "cpu (host wall)"
        assert r["ms"] > 0 and r["plain_ms"] > 0 and r["bound_ms"] > 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rows
    # the small planes' shapes, and the launch floor's one byte
    assert {tuple(r["shape"]) for r in rows} == {(4, 64, 64), (1, 64, 64), (1, 96, 128),
                                                 (1, 1, 1)}


def test_kernel_bench_rejects_unknown_form():
    with pytest.raises(ValueError, match="unknown forms"):
        kernel_bench.bench(("no such form",), device="cpu", small=True)
