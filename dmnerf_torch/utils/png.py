"""A minimal PNG reader and writer on the standard library (zlib + struct)
and numpy, so that the port reads and writes the reference's image formats
without imageio or Pillow.

write_png writes 8-bit greyscale [H, W] or RGB [H, W, 3] uint8 images and
16-bit greyscale uint16 [H, W] ones (ScanNet's depth frames), unfiltered
and deflate-compressed: what the render harness, the stress scene writer
and the ScanNet export write.

read_png returns what imageio.v2.imread (through Pillow) returns for the same
file, in dtype, shape and values:
- colour types 0 (grey) [H, W], 2 (RGB) [H, W, 3], 4 (grey + alpha)
  [H, W, 2] and 6 (RGBA) [H, W, 4] at 8 bits, uint8;
- colour type 0 at 16 bits as uint16 [H, W]; colour type 2 at 16 bits as
  uint8 [H, W, 3], the high byte of each sample, as Pillow decodes it;
- colour type 3 (palette) at 1, 2, 4 or 8 bits, expanded to RGB uint8
  [H, W, 3] (a tRNS chunk is ignored, as imageio ignores it);
- all five scanline filters. None, Sub and Up cost one numpy operation per
  row; an image with an Average or Paeth row, whose bytes depend on the
  decoded byte to their left, is decoded along anti-diagonals of pixels,
  each a strided slice of a padded copy (one pass of numpy operations per
  diagonal, H + W - 1 passes).
Interlaced (Adam7) files, other bit depths, a bad CRC or a truncated stream
raise a ValueError that names the file and the field.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color_type = 16, 0           # 16-bit greyscale, big-endian samples
        img = img.astype(">u2")
    elif img.dtype != np.uint8:
        raise TypeError(f"write_png: expected uint8, or uint16 [H,W], got {img.dtype} "
                        f"{img.shape}")
    elif img.ndim == 2:
        depth, color_type = 8, 0            # greyscale
    elif img.ndim == 3 and img.shape[2] == 3:
        depth, color_type = 8, 2            # truecolour
    else:
        raise ValueError(f"write_png: expected [H,W] or [H,W,3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    # each scanline starts with its filter type byte (0 = none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _chunks(path: str, data: bytes):
    """(tag, payload) of every chunk, CRCs checked, up to IEND."""
    pos = len(_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: PNG stream ends before its IEND chunk")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: chunk {tag!r} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length


def _unfilter_rows(x: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Scanlines whose filters are only None (0), Sub (1) and Up (2)."""
    h, stride = x.shape
    if not ft.any():
        return x.copy()
    out = np.empty_like(x)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        if ft[r] == 0:
            out[r] = x[r]
        elif ft[r] == 1:                    # per-channel running sum, mod 256
            out[r] = np.cumsum(x[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            np.add(x[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_diagonals(x: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters. Pixel (r, p) depends on (r, p-1), (r-1, p)
    and (r-1, p-1), so the pixels of one anti-diagonal r + p = d depend only
    on earlier diagonals. In a copy padded with a zero row and column and
    flattened with row length n + 1, pixel (r, p) sits at
    (r+1)(n+1) + p + 1 = d + n + 2 + r*n: a diagonal is a slice of step n."""
    h, stride = x.shape
    n = stride // bpp
    wp = n + 1
    xs = np.zeros((h + 1, wp, bpp), np.int16)
    xs[1:, 1:] = x.reshape(h, n, bpp)
    fs = np.zeros((h + 1, wp, 1), np.int16)
    fs[1:] = ft.astype(np.int16)[:, None, None]
    xs, fs = xs.reshape(-1, bpp), fs.reshape(-1, 1)
    out = np.zeros_like(xs)
    for d in range(h + n - 1):
        r0, r1 = max(0, d - n + 1), min(h - 1, d)
        s = slice(d + n + 2 + r0 * n, d + n + 3 + r1 * n, n)
        sa = slice(s.start - 1, s.stop - 1, n)              # left
        sb = slice(s.start - wp, s.stop - wp, n)            # up
        sc = slice(s.start - wp - 1, s.stop - wp - 1, n)    # up-left
        a, b, c, f = out[sa], out[sb], out[sc], fs[s]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 0, 0, np.where(f == 1, a, np.where(
            f == 2, b, np.where(f == 3, (a + b) >> 1, paeth))))
        out[s] = (xs[s] + pred) & 0xFF
    return out.reshape(h + 1, wp, bpp)[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    header, palette, idat = None, None, []
    for tag, body in _chunks(path, data):
        if tag == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: IHDR holds {len(body)} bytes, expected 13")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            if len(body) % 3:
                raise ValueError(f"{path}: PLTE length {len(body)} is not a multiple of 3")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag != b"IEND" and not tag[0] & 0x20:       # an unknown critical chunk
            raise ValueError(f"{path}: unsupported critical chunk {tag!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: IHDR colour type {ctype} is not a PNG colour type")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: IHDR bit depth {depth} at colour type {ctype} is not "
                         f"supported (supported: {_DEPTHS[ctype]})")
    if interlace:
        raise ValueError(f"{path}: IHDR interlace method {interlace} (Adam7) is not supported")
    if compression or filt:
        raise ValueError(f"{path}: IHDR compression {compression} / filter method {filt} "
                         "is not 0")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: colour type 3 without a PLTE chunk")

    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: IDAT does not inflate ({e})") from None
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: IDAT inflates to {len(raw)} bytes, expected "
                         f"{h * (stride + 1)} for {w}x{h}")
    a = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ft, x = a[:, 0], a[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"{path}: scanline filter type {int(ft.max())} is not 0-4")
    rows = (_unfilter_diagonals(x, ft, bpp) if (ft >= 3).any()
            else _unfilter_rows(x, ft, bpp))

    if ctype == 3:
        if depth < 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
            idx = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(-1)
        else:
            idx = rows[:, :w]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index {int(idx.max())} beyond the "
                             f"{len(palette)}-entry PLTE")
        return palette[idx]
    if depth == 16:
        px = rows.reshape(h, w, ch, 2)
        if ctype == 0:
            return (px[..., 0, 0].astype(np.uint16) << 8) | px[..., 0, 1]
        return np.ascontiguousarray(px[..., 0])             # RGB: the high bytes
    px = rows.reshape(h, w, ch)
    return np.ascontiguousarray(px[..., 0] if ch == 1 else px)


if __name__ == "__main__":
    # python -m dmnerf_torch.utils.png FILE...: each file's array and the
    # seconds read_png takes for it
    import sys
    import time

    for p in sys.argv[1:]:
        t0 = time.perf_counter()
        arr = read_png(p)
        print(f"{p}: {arr.dtype} {arr.shape}, read in {time.perf_counter() - t0:.4f} s")
