"""A small PNG encoder on :mod:`zlib` and :mod:`struct` (no cv2, no libpng).

It writes 8-bit gray (``[H, W]``) or RGB (``[H, W, 3]``) images, one IDAT
chunk, filter type 0 on every row. Its bytes differ from libpng's or cv2's;
its pixels do not, and the byte encoding is not part of the persisted
artifacts' contract (``persistence.py:199-200`` of the JAX package): only
decoded pixels are.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 1) -> bytes:
    """uint8 gray [H, W] or RGB [H, W, 3] -> PNG bytes, zlib ``level`` 1
    by default (cv2's default PNG compression: the UI's 4096x3000 canvas is
    encoded on every redraw)."""
    a = np.ascontiguousarray(image, dtype=np.uint8)
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: expected [H, W] or [H, W, 3] uint8, got {a.shape}")
    h, w = a.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("encode_png: empty image")
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))
