"""A minimal PNG writer on the standard library (zlib + struct).

Writes 8-bit greyscale [H, W] or RGB [H, W, 3] uint8 images, unfiltered and
deflate-compressed: what the render harness writes, without imageio.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png: expected uint8, got {img.dtype}")
    if img.ndim == 2:
        color_type = 0                      # greyscale
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2                      # truecolour
    else:
        raise ValueError(f"write_png: expected [H,W] or [H,W,3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    # each scanline starts with its filter type byte (0 = none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
