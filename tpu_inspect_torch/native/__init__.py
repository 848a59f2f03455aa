"""Native (C++) libraries of the port, compiled with g++ at first use into
the gitignored ``tpu_inspect_torch/_build/`` (each file name keyed by a hash
of its source) and loaded through ctypes.

``tin_io.cc``: image decode through libpng + libtiff, a copy of
:mod:`tpu_inspect.native` (the same source, ctypes signatures and Python
contract), so the port never imports the JAX package. ``tin_io`` stands in
for the reference's Qt/OpenCV C++ decode (indexing_ui.py:145-194). Any
failure (no compiler, no libpng/libtiff, an unsupported file layout) makes
:func:`decode` return None and the callers fall back to cv2, so the native
path can never break parity.

``band_copy.cc``: a host buffer copied in bands on a persistent pool of
threads (:func:`copy_bands`), for the capture stream's copy into its pinned
upload slot (:func:`tpu_inspect_torch.streaming._copy_rows`). Without the
library :func:`copy_bands` copies nothing and returns False, and the caller
copies on its own thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "tin_io.cc"
_BAND_SRC = _SRC.with_name("band_copy.cc")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}  # source name -> library, None once it failed

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path(src: Path = _SRC) -> Path:
    """Where the library for the current ``src`` lives (built or not)."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _build(out: Path, src: Path, link: tuple[str, ...]) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-pthread", str(src), "-o", str(tmp), *link]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load(src: Path, link: tuple[str, ...], bind) -> ctypes.CDLL | None:
    """Load (building if needed) the library of ``src`` and ``bind`` its
    signatures; None when it is unavailable, and from then on."""
    if src.name in _libs:
        return _libs[src.name]
    with _lock:
        if src.name not in _libs:
            lib = None
            try:
                path = library_path(src)
                if path.exists() or _build(path, src, link):
                    lib = ctypes.CDLL(str(path))
                    bind(lib)
            except OSError:
                lib = None
            _libs[src.name] = lib
    return _libs[src.name]


def _bind_tin_io(lib: ctypes.CDLL) -> None:
    lib.tin_decode.restype = ctypes.c_int
    lib.tin_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_U8P), _I32P, _I32P, _I32P, _I32P,
    ]
    lib.tin_free.restype = None
    lib.tin_free.argtypes = [_U8P]
    lib.tin_version.restype = ctypes.c_char_p
    lib.tin_encode_png_gray8.restype = ctypes.c_int
    lib.tin_encode_png_gray8.argtypes = [
        ctypes.c_char_p, _U8P, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tin_loader_create.restype = ctypes.c_void_p
    lib.tin_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.tin_loader_next.restype = ctypes.c_int
    lib.tin_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_U8P), _I32P, _I32P, _I32P, _I32P,
    ]
    lib.tin_loader_destroy.restype = None
    lib.tin_loader_destroy.argtypes = [ctypes.c_void_p]


def _bind_band_copy(lib: ctypes.CDLL) -> None:
    lib.bc_copy.restype = ctypes.c_int
    lib.bc_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the decode library; None when unavailable."""
    return _load(_SRC, ("-lpng", "-ltiff"), _bind_tin_io)


def copy_bands(dst: np.ndarray, src: np.ndarray, offsets) -> bool:
    """Copy bytes ``[offsets[i], offsets[i + 1])`` of ``src`` into ``dst``
    for every band ``i`` on the library's pool of threads, the calling
    thread one of them; every band has landed on return. ``dst`` and
    ``src`` are C-contiguous and apart, ``dst`` writeable, and ``offsets``
    rise from 0 to at most either's size (else ValueError). Returns False,
    having copied nothing, when the library is unavailable."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if not (dst.flags.c_contiguous and src.flags.c_contiguous and dst.flags.writeable):
        raise ValueError("copy_bands takes C-contiguous arrays and a writeable destination")
    if (len(offsets) < 2 or offsets[0] != 0 or (np.diff(offsets) <= 0).any()
            or offsets[-1] > min(dst.nbytes, src.nbytes)):
        raise ValueError(f"band offsets {offsets.tolist()} do not rise from 0 within "
                         f"{min(dst.nbytes, src.nbytes)} bytes")
    if np.may_share_memory(dst, src):
        raise ValueError("copy_bands takes buffers that do not overlap")
    lib = _load(_BAND_SRC, (), _bind_band_copy)
    if lib is None:
        return False
    rc = lib.bc_copy(dst.ctypes.data, src.ctypes.data, offsets.ctypes.data, len(offsets) - 1)
    if rc != 0:
        raise RuntimeError(f"bc_copy returned {rc}")
    return True


def version() -> str | None:
    """The library's version string, or None when it is unavailable."""
    lib = get_lib()
    return lib.tin_version().decode() if lib is not None else None


def decode(path: str) -> np.ndarray | None:
    """Decode PNG/TIFF to a numpy array in cv2.imread(IMREAD_UNCHANGED)
    conventions (uint8/uint16; [H,W] gray, [H,W,3] BGR, [H,W,4] BGRA).

    Returns None whenever the native path cannot reproduce cv2 bit-exactly
    (unsupported layout, build failure, other containers): callers fall
    back to cv2.
    """
    lib = get_lib()
    if lib is None:
        return None
    data = _U8P()
    w, h, ch, depth = (ctypes.c_int32() for _ in range(4))
    rc = lib.tin_decode(
        os.fsencode(str(path)), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(ch), ctypes.byref(depth),
    )
    if rc != 0:
        return None
    return _unpack_frame(lib, data, w.value, h.value, ch.value, depth.value)


def _unpack_frame(lib, data, w: int, h: int, ch: int, depth: int) -> np.ndarray:
    """Copy a tin-owned pixel buffer into a numpy array and free it."""
    try:
        nbytes = h * w * ch * (depth // 8)
        raw = ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
        arr = np.frombuffer(raw, dtype=np.uint8 if depth == 8 else np.uint16).copy()
    finally:
        lib.tin_free(data)
    if ch == 1:
        return arr.reshape(h, w)
    return arr.reshape(h, w, ch)


def encode_png_gray(path: str, img: np.ndarray) -> bool:
    """Write [H, W] uint8 as a grayscale PNG with libpng.

    Returns False (the caller falls back to another encoder) when the
    native library is unavailable or the write fails.
    """
    lib = get_lib()
    if lib is None or img.ndim != 2 or img.dtype != np.uint8:
        return False
    arr = np.ascontiguousarray(img)
    rc = lib.tin_encode_png_gray8(
        os.fsencode(str(path)), arr.ctypes.data_as(_U8P), np.int32(arr.shape[1]),
        np.int32(arr.shape[0]),
    )
    return rc == 0


class StreamLoader:
    """In-order prefetching decoder over a list of image paths.

    A native worker pool (tin_loader_*) decodes frames ahead of the consumer
    into a bounded queue, so host decode overlaps device compute in
    streaming deployments (:mod:`tpu_inspect_torch.streaming`). The
    reference decodes on the UI thread at image-switch time instead
    (indexing_ui.py:145-194).

    Iterating yields one item per path, in order: a numpy array in
    :func:`decode` conventions, or None when the native path declined that
    frame (the caller decodes it another way, exactly as when
    :func:`decode` returns None). When the native library is unavailable
    every frame yields None.
    """

    def __init__(self, paths, capacity: int = 4, threads: int = 3):
        self._paths = [str(p) for p in paths]
        self._lib = get_lib()
        self._handle = None
        if self._lib is not None and self._paths:
            n = len(self._paths)
            arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in self._paths])
            self._handle = self._lib.tin_loader_create(
                arr, np.int32(n), np.int32(max(1, int(capacity))),
                np.int32(max(1, int(threads))),
            )

    def __len__(self) -> int:
        return len(self._paths)

    def __iter__(self):
        try:
            for _ in self._paths:
                # re-read the handle each step: close() while the iterator
                # is suspended must degrade to None frames, never touch a
                # destroyed loader
                handle = self._handle
                if handle is None:
                    yield None
                    continue
                data = _U8P()
                w, h, ch, depth = (ctypes.c_int32() for _ in range(4))
                rc = self._lib.tin_loader_next(
                    handle, ctypes.byref(data), ctypes.byref(w), ctypes.byref(h),
                    ctypes.byref(ch), ctypes.byref(depth),
                )
                if rc != 0:
                    yield None
                    continue
                yield _unpack_frame(self._lib, data, w.value, h.value, ch.value, depth.value)
        finally:
            self.close()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tin_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
