"""The control of the comparison: the plain reference computed one rung
lower (``benchmark.reference.chain.inspect``'s ``low``:
the blur and the adaptive mean in bfloat16, the Otsu scan and the
max-area product in float32), put in the program's place on a cell's
captures and judged by ``benchmark.compare`` against the reference. It
has to come out not correct::

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed: the compared numbers and whether they pass.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import compare, mix
from benchmark.loop import Frame


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The compared numbers of the lowered reference against the
    reference on the pool of ``seed``: every capture once."""
    kind = mix.load(traffic)
    pool = kind.pool(cfg, seed, device)
    anchored = kind.anchored
    ref = compare.reference_answers(pool, cfg, anchored)
    low = compare.reference_answers(pool, cfg, anchored, low=True)
    answered = []
    for p, r in enumerate(low):
        f = Frame(p, p, 0.0, done=0.0)
        f.answers = (np.zeros(1, np.int32), r["verdict"], r["area"], r["found"])
        answered.append(f)
    last = {p: {"seg_mask": r["seg_mask"], "shift": r["shift"], "defect_mask": r["defect_mask"]}
            for p, r in enumerate(low)}
    return compare.count(answered, last, ref)


def main(argv=None) -> int:
    from benchmark.run import cell_parts, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, cfg, traffic, _, _ = cell_parts(spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        n = readings(cfg, traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": n,
                          "passes": compare.passed(n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
