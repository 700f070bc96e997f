"""Baseline JPEG files on the standard library, numpy and a C++ codec
(native/jpeg.cpp, built by g++ into build/native/ at first use).

read_jpeg returns what imageio.v2.imread returns through Pillow on
libjpeg-turbo, to the bit: uint8 [H, W, 3] for a YCbCr file, [H, W] for a
greyscale one. write_jpeg writes the bytes that imageio.v2.imwrite writes for
a uint8 [H, W, 3] or [H, W] array (JFIF, the standard tables at quality 75,
4:2:0, baseline). Files the codec does not read (progressive, lossless,
arithmetic-coded, 12-bit, CMYK or Adobe, truncated, a bad marker) raise a
ValueError that names the file and the marker. There is no fallback: if g++
cannot build the codec, both raise a RuntimeError with g++'s message.
"""

from __future__ import annotations

import os

import numpy as np

from dmnerf_torch import native


def _codec():
    return native.require("_jpeg_native", "jpeg.cpp")


def read_jpeg(src) -> np.ndarray:
    """A JPEG file (a path, or its bytes) -> uint8 [H, W, 3] or [H, W]."""
    codec = _codec()
    if isinstance(src, (bytes, bytearray, memoryview)):
        data, name = bytes(src), "<bytes>"
    else:
        with open(src, "rb") as f:
            data, name = f.read(), os.fspath(src)
    try:
        return codec.decode(data)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """The bytes of the file that write_jpeg writes (a .sens colour blob)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_jpeg takes a uint8 [H, W, 3] or [H, W] array, not "
                         f"{img.dtype} {list(img.shape)}")
    return _codec().encode(np.ascontiguousarray(img), int(quality))


def write_jpeg(path, img: np.ndarray, quality: int = 75) -> None:
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
