"""Count the shared-memory loads against the arithmetic in a kernel's SASS.

Compiles one ``csrc`` source to a cubin for the H100 (``nvcc -cubin
-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3``), disassembles it
with ``cuobjdump -sass`` and prints, for every kernel in it, the static
count of each opcode that the kernels' cost models name (shared loads and
stores by width, FFMA, FADD, FMUL, IMAD, local-memory LDL/STL, MOV, shared
atomics, the double operations and MUFU: a double division is one
MUFU.RCP64H and its refinements), over
the whole function and over each loop (the instructions between a
backward branch and its target). It runs where ``nvcc`` and
``cuobjdump`` are (the card's host), e.g.::

    python -m tpu_inspect_torch.tools.sass_count tpu_inspect_torch/csrc/adaptive_mean.cu

One JSON line a source closes the output: {source, kernels: [{name,
counts, loops: [{start, end, counts}]}]}.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

# the opcodes counted (by their name before the first '.'), and LDS/STS
# also by width
COUNTED = ("LDS", "STS", "LDG", "STG", "LDL", "STL", "FFMA", "FADD", "FMUL", "IMAD", "MOV",
           "BRA", "ATOMS", "DFMA", "DMUL", "DADD", "MUFU")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _count(ops) -> dict:
    c = Counter()
    for op in ops:
        base = op.split(".")[0]
        if base in COUNTED:
            c[base] += 1
        if base in ("LDS", "STS"):
            c[op if "." in op else base + ".32"] += 1
    c["total"] = len(ops)
    return dict(sorted(c.items()))


def parse(sass: str) -> list[dict]:
    """Each kernel of ``cuobjdump -sass`` text: its name, opcode counts and
    loops (a backward ``BRA``'s target to the branch, counted alike)."""
    kernels, cur = [], None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = {"name": m.group(1), "insns": []}
            kernels.append(cur)
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur["insns"].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    out = []
    for k in kernels:
        insns = k["insns"]
        loops = []
        for addr, op, args in insns:
            t = re.match(r"(0x[0-9a-f]+)", args)
            if op.split(".")[0] == "BRA" and t and int(t.group(1), 16) <= addr:
                lo = int(t.group(1), 16)
                loops.append({"start": lo, "end": addr,
                              "counts": _count([o for a, o, _ in insns if lo <= a <= addr])})
        out.append({"name": k["name"], "counts": _count([o for _, o, _ in insns]),
                    "loops": loops})
    return out


def sass_of(source: Path, nvcc: str = "nvcc", cuobjdump: str = "cuobjdump") -> str:
    with tempfile.TemporaryDirectory() as d:
        cubin = Path(d) / "k.cubin"
        subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-o", str(cubin), str(source)], check=True)
        return subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m tpu_inspect_torch.tools.sass_count",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--sass-out", type=Path, help="directory to keep each source's SASS in")
    args = ap.parse_args(argv)
    from tpu_inspect_torch.kernels.build import find_nvcc

    nvcc = find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    rows = []
    for src in args.sources:
        sass = sass_of(src, nvcc, cuobjdump)
        if args.sass_out:
            args.sass_out.mkdir(parents=True, exist_ok=True)
            (args.sass_out / f"{src.stem}.sass").write_text(sass)
        kernels = parse(sass)
        for k in kernels:
            print(f"{src} {k['name']}: {k['counts']}")
            for lp in k["loops"]:
                print(f"    loop {lp['start']:#x}-{lp['end']:#x}: {lp['counts']}")
        rows.append({"source": str(src), "kernels": kernels})
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
