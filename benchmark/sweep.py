"""The knee of a configuration: a cell's mix, run as the ``open`` kind at
each of a list of rates, to find once, on the card, the highest rate it
sustains (the rate an open mix's file then fixes)::

    python3 -m benchmark.sweep --workload <cell> --rates 500 600 700 --seconds 10

For each rate it prints one JSON line: the rate offered and the frames
answered a second, the median latency of the window's first and last
fifth (a backlog that grows shows as a rise) and the 95th percentile.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    from benchmark.loop import p95
    from benchmark.run import cell_parts, run_cell, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    _, cfg, traffic, _, _ = cell_parts(spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for rate in args.rates:
        mix = dict(traffic, kind="open", rate_per_s=rate)
        run, out = run_cell(cfg, mix, args.seed, args.seconds, device=torch.device("cuda", 0))
        lat = np.array([(f.done - f.due) * 1e3 for f in run.frames if f.done is not None])
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate_per_s": rate, "answered_per_s": len(lat) / args.seconds,
            "first_fifth_median_ms": float(np.median(lat[:fifth])),
            "last_fifth_median_ms": float(np.median(lat[-fifth:])),
            "p95_ms": p95(lat), "correct": out["numbers"]["unanswered"] == 0
            and all(v == 0 for v in out["numbers"].values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
