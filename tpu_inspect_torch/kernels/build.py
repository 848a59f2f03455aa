"""Build the CUDA sources under ``tpu_inspect_torch/csrc`` and bind them.

All ``csrc/*.cu`` files compile, at first use, into ONE shared library with
a plain C interface: one ``nvcc -c`` per source, all started together, then
one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu   # each, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libtik_<hash>.so _build/*.o

(no PyTorch headers, so a build takes seconds). The file name carries a
hash of the sources, so an edited source rebuilds and an unchanged one
loads the cached library. The library is loaded with :mod:`ctypes`; every
pointer and the stream are ``c_void_p`` (an undeclared argtype would pass a
32-bit int and cut the pointer), every size ``c_int`` (``c_longlong`` for a
count that may pass 2^31), and every entry
returns ``cudaGetLastError()`` as an int, which :func:`check` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry name -> argtypes (all return int: the cudaError_t of the launch)
_SIGNATURES = {
    # x, thr, prog, out, stats, scratch, scratch words, err, U, H, W,
    # has_thr, fill, out_largest, stream
    "tik_seg_tail": (_P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, row_lo, row_hi, out, U, H, W, k, thr, strip rows, stream
    "tik_median_residual": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # fg, roi, max_x2, table, prog, out, area, scratch, scratch words, err,
    # U, H, W, min_x2, has_roi, stream
    "tik_blob_filter": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _P),
    # seed, domain, out, parent, flags, bits, err, U, H, W, conn8, border_seed,
    # stream
    "tik_propagate": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # fg, out, parent, bits, err, U, H, W, stream
    "tik_label": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # labels, fg, mask, stats, scratch, err, U, H, W, stream
    "tik_component_stats": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # fill_labels, top, ext, max_x2, out, area, sums, err, U, H, W, min_x2,
    # stream
    "tik_blob_select": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the contour table (host memory), once per device
    "tik_blob_select_setup": (_P,),
    # x, out, U, H, W, k, strip rows, stream
    "tik_median_blur": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x, thr, roi, out, prog, U, H, W, tile rows, tile words, row reach,
    # column reach, big, stream
    "tik_morph_chain": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # fg, mask, stats, scratch, err, U, H, W, CTAs a unit at most, opt-in
    # shared memory, stream
    "tik_label_stats": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out: [opt-in shared memory, largest cluster] (int32), once per device
    "tik_label_stats_setup": (_P,),
    # U, H, W, CTAs a unit at most, opt-in shared memory, out: scratch
    # int32 words (int64)
    "tik_label_stats_scratch": (_I, _I, _I, _I, _I, _P),
    # out (one byte), stream: a one-thread launch (the kernel rig's floor)
    "tik_launch_floor": (_P, _P),
    # x, thr, prog, roi_prog, zone, seg_out, seg_stats, roi_out, roi_stats,
    # scratch, scratch words, err, U, H, W, stream
    "tik_seg_roi_tail": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _P),
    # x, row_lo, row_hi, out, U, H, W, k, thr, mode, strip rows, stream
    "tik_median_probe": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, hist (or null), partials (or null), U, H*W, chunk, CTAs a unit,
    # stream
    "tik_histogram": (_P, _P, _P, _I, _L, _L, _I, _P),
    # hist (or null), partials (or null), partial rows a unit, thr, U,
    # scale, stream
    "tik_otsu_scan": (_P, _P, _I, _P, _I, ctypes.c_double, _P),
    # x, taps, row index table, column index table, out, U, H, W, k, stream
    "tik_gauss_blur": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, taps, out, U, H, W, k, C, mode (0 mean, 1 BINARY_INV), stream
    "tik_adaptive_mean": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, strong, cand, U, H, W, low, high, stream
    "tik_canny_head": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the tpu_inspect_torch CUDA kernels are compiled from csrc/*.cu at "
        "first use and need the CUDA toolkit"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libtik_{source_hash()}.so"


def build(extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile the sources unless a library for this source hash exists.

    Each ``.cu`` compiles in its own nvcc process, all started together;
    ``extra_flags`` go to those compiles. Returns (library path, compiler
    output — empty when cached). Raises RuntimeError with nvcc's output
    when the build fails.
    """
    out = library_path()
    if out.exists() and not extra_flags:
        return out, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    base = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    cmds = [[*base, *extra_flags, "-c", "-o", str(o), str(p)] for p, o in zip(srcs, objs)]
    logs = []
    try:
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        failed = []
        for cmd, proc in zip(cmds, procs):
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{logs[-1]}"
            )
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out, "".join(logs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = cdll
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and only cudaGetLastError says so)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_bounded(name: str, err_flag) -> None:
    """Raise if a kernel set its device error flag (a loop that hit its
    bound, or a label outside its plane: the result would be wrong, so it is
    never returned). Reading the flag waits for the kernel."""
    check_flag(name, int(err_flag.item()))


def check_flag(name: str, code: int) -> None:
    """:func:`check_bounded` on a flag value already read (with other
    results, in one copy)."""
    if code != 0:
        raise RuntimeError(
            f"{name}: kernel set its error flag {code} (1, 2: an iteration bound; "
            "3: a label outside its plane)"
        )
