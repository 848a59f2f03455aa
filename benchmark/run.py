"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (counted as ``setup_s``, from the start
of this process): the port is imported and its kernels built or loaded,
the traffic mix's pool of captures is made on the card from ``--seed``,
the program is readied for the mix (its kind's ``prepare``), and it runs
over the pool twice. Then the window: ``--seconds`` of the mix, run by
its kind (``benchmark.mix``). After it the masks of each capture's last
pass are copied out, the program's state is freed, and the plain reference
(``benchmark.reference``) runs on the same captures; every answer is
compared (``benchmark.compare``).

stdout's last line is the result: ``correct``, ``attempted`` and
``failed`` frames, the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics and the ``breakdown`` (``--trace 1``), ``device``, and
last ``checks``, each compared number with its limit; stderr ends with
the same numbers. Without a CUDA card, or with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_inspect"}  # top-level module names
WARM_PASSES = 2  # set-up runs the program over the pool this many times
DRAIN_S = 60.0  # how long answers due in the window are awaited after it

# caches that PyTorch might fill at run time stay in the checkout, at fixed
# paths, so a second run finds them
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / ".bench_cache" / "torch_kernels"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare, mix  # noqa: E402
from benchmark.loop import Loop, clock, p95  # noqa: E402


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_parts(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration, traffic mix, end-to-end metrics, per-layer
    metrics) of cell ``name``, each found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as fh:
        cfg = json.load(fh)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return cell, cfg, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``, which returns
    the metric from a :class:`Run`, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a run leaves for the per-layer readers."""

    cfg: dict
    traffic: dict
    frames: list = field(default_factory=list)  # the window's frames
    t0: float = 0.0
    t1: float = 0.0
    seconds: float = 0.0
    setup_s: float = 0.0
    slices: dict = field(default_factory=dict)  # benchmark.trace.Slice by name
    in_slice: set = field(default_factory=set)
    untraced_s: float = 0.0  # the window's seconds before the first slice

    def answered_before(self, t: float) -> int:
        """Frames of the window answered, unrefused, before time ``t``."""
        return sum(1 for f in self.frames if f.answers is not None
                   and int(f.answers[0][0]) == 0 and f.done < t)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool = False,
             device="cuda", t_start: float | None = None) -> tuple[Run, dict]:
    """One run of configuration ``cfg`` under mix ``traffic``: returns the
    :class:`Run` and a dict of ``memory_peak_bytes``, the
    compared ``numbers`` and the generator's lateness. ``device="cpu"``
    drives the same run on the port's plain versions (the tests)."""
    from benchmark.program import Program

    t_start = _T_START if t_start is None else t_start
    dev = torch.device(device)
    kind = mix.load(traffic)
    program = Program(cfg, dev)
    log("port imported")
    pool = kind.pool(cfg, seed, dev)
    log(f"{len(pool)} captures made")
    kind.prepare(program, pool)

    warm = Loop(program, pool)
    n_warm = WARM_PASSES * len(pool)
    kind.warm(warm, n_warm)
    warm.drain(DRAIN_S)
    if trace:
        from benchmark import trace as tr

        tr.warm(lambda: (warm.dispatch(clock()), warm.drain(DRAIN_S)))
    bad = sum(1 for f in warm.frames if f.answers is None or int(f.answers[0][0]) != 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del warm
    log(f"warm-up: {n_warm} frames")

    run = Run(cfg, traffic, seconds=seconds)
    tracer = None
    loop = Loop(program, pool)
    if trace:
        tracer = tr.Tracer(loop, seconds)
        loop.tracer = tracer
    run.setup_s = clock() - t_start
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    log("window opens")
    loop.mark()
    run.t0, run.t1 = kind.run(loop, seconds)
    loop.drain(DRAIN_S)
    if tracer:
        tracer.finish()
        run.slices, run.in_slice = tracer.slices, tracer.in_slice
        run.untraced_s = (tracer.first or run.t1) - run.t0
    run.frames = loop.window(run.t0, run.t1)
    done = np.array([f.done - run.t0 for f in run.frames if f.done is not None])
    log(f"window closed: {len(run.frames)} frames; answered a second: "
        f"{np.bincount(done[done < seconds].astype(int)).tolist()}")
    late = [f.start - f.due for f in run.frames]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    last = {p: {"seg_mask": _host(m), "shift": _host(s), "defect_mask": _host(d)}
            for p, (m, s, d) in loop.last.items()}
    del loop, program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    ref = compare.reference_answers(pool, cfg, kind.anchored)
    numbers = compare.count(run.frames, last, ref)
    numbers["unanswered"] += bad
    log(f"reference and comparison: {clock() - t_ref:.2f} s")
    return run, {"memory_peak_bytes": peak, "numbers": numbers,
                 "late_s": late, "reference_s": clock() - t_ref}


def _loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec()
    cell, cfg, traffic, e2e, layer = cell_parts(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)  # the host's share is one thread's dispatch
    dev = torch.device("cuda", 0)
    run, out = run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace), dev)
    found = _loaded_forbidden()
    if found:
        log(f"forbidden modules loaded in this process: {', '.join(found)}")
        return 3

    numbers = out["numbers"]
    metrics = {}
    for m in layer if args.trace else e2e:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": compare.passed(numbers), "attempted": len(run.frames),
              "failed": numbers["unanswered"], "metrics": metrics, "device": dev_info}
    if args.trace:
        from benchmark.trace import breakdown

        s = run.slices.get("device")
        dev_info["busy_s"] = s.busy_s() if s else 0.0
        dev_info["window_s"] = s.wall_s if s else 0.0
        result["breakdown"] = breakdown(run.slices)
    result["checks"] = compare.checks(numbers)
    late = out["late_s"]
    notes = {"generator_late_ms": {"p95": p95(late) * 1e3 if late else None,
                                   "max": max(late) * 1e3 if late else None},
             "reference_s": out["reference_s"], "setup_s": run.setup_s}
    s = run.slices.get("device")
    if s and s.frames and run.untraced_s > 0:
        # the device slice's busy seconds a frame at the untraced window's rate
        rate = run.answered_before(run.t0 + run.untraced_s) / run.untraced_s
        notes["idle_at_untraced_rate"] = 1.0 - s.busy_s() / s.frames * rate
    print(json.dumps(notes), flush=True)
    print(json.dumps(result), flush=True)
    for k, v in numbers.items():
        log(f"check {k}: {v} (limit {compare.LIMITS[k]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
