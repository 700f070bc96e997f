"""dmnerf_torch/utils/png.py: what write_png writes reads back equal through
imageio and through read_png, and read_png returns what imageio.v2.imread
returns (dtype, shape and values, exactly) on Pillow-written files of every
supported colour type and depth, on hand-built files that use each of the
five scanline filters, and on odd widths; it raises a ValueError on what it
does not decode."""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from dmnerf_torch.utils.png import read_png, write_png


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (1, 1), (64, 33, 3)])
def test_png_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = imageio.imread(path)
    assert back.dtype == np.uint8 and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    mine = read_png(path)
    assert mine.dtype == np.uint8 and mine.shape == img.shape
    np.testing.assert_array_equal(mine, img)


def test_png_rejects_other_layouts(tmp_path):
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), np.zeros((4, 4, 4), np.uint8))


def _same_as_imageio(path):
    got, want = read_png(path), imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    return got


def _smooth(h, w, c, rng):
    """Gradients plus noise: Pillow's adaptive filtering then picks Sub, Up,
    Average and Paeth rows, where pure noise gives mostly None."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx[..., None] * (1 + np.arange(c)) + yy[..., None] * 3) % 256
    return ((base + rng.integers(0, 4, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "RGB", "LA", "RGBA"])
@pytest.mark.parametrize("size", [(48, 64), (31, 37)])
def test_read_png_equals_imageio_on_pillow_8bit_files(tmp_path, mode, size):
    rng = np.random.default_rng(1)
    c = len(mode)
    img = _smooth(*size, c, rng)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if c == 1 else img, mode=mode).save(path)
    _same_as_imageio(path)


@pytest.mark.parametrize("size", [(48, 64), (31, 37)])
def test_read_png_equals_imageio_on_pillow_16bit_grey(tmp_path, size):
    img = np.random.default_rng(2).integers(0, 65536, size, dtype=np.uint16)
    path = str(tmp_path / "i16.png")
    Image.fromarray(img).save(path)
    got = _same_as_imageio(path)
    assert got.dtype == np.uint16


@pytest.mark.parametrize("colours", [2, 4, 16, 200])
def test_read_png_equals_imageio_on_pillow_palette_files(tmp_path, colours):
    """Pillow writes a palette image at 1, 2, 4 or 8 bits by its colour count;
    imageio expands it to RGB."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, colours, (30, 37)).astype(np.uint8)
    im = Image.fromarray(idx, mode="L").convert("P")
    im.putpalette(rng.integers(0, 256, 3 * colours).tolist())
    path = str(tmp_path / "p.png")
    im.save(path)
    assert _same_as_imageio(path).shape == (30, 37, 3)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows, bpp, filters):
    """Encode scanlines (uint8 [H, stride]) with the given filter per row,
    byte by byte as the PNG specification writes them."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for row, ft in zip(rows.astype(np.int64), filters):
        enc = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            enc.append((x - pred) % 256)
        out.append(bytes([ft]) + bytes(enc))
        prev = row
    return b"".join(out)


def _hand_png(path, img, depth, ctype, filters, palette=None, interlace=0):
    h, w = img.shape[:2]
    if depth == 16:
        rows = img.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:
        bits = np.unpackbits(img.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        rows = img.reshape(h, -1)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    data = _filtered(rows, max(1, ch * depth // 8), filters)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
        if palette is not None:
            f.write(_chunk(b"PLTE", palette.tobytes()))
        f.write(_chunk(b"IDAT", zlib.compress(data)))
        f.write(_chunk(b"IEND", b""))


KINDS = {  # name: (depth, colour type, pixel shape, value bound)
    "grey8": (8, 0, (), 256), "rgb8": (8, 2, (3,), 256), "ga8": (8, 4, (2,), 256),
    "rgba8": (8, 6, (4,), 256), "grey16": (16, 0, (), 65536), "rgb16": (16, 2, (3,), 65536),
    "palette8": (8, 3, (), 40), "palette4": (4, 3, (), 16), "palette2": (2, 3, (), 4),
}


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_png_equals_imageio_on_each_filter(tmp_path, kind, filters):
    """Hand-built files whose every row uses one filter (or a seeded mix of
    all five), at an odd width of 13, of each supported kind. A 16-bit RGB
    file comes back as its high bytes in uint8, as imageio gives it."""
    depth, ctype, px, bound = KINDS[kind]
    rng = np.random.default_rng(4)
    h, w = 9, 13
    img = rng.integers(0, bound, (h, w) + px).astype(np.uint16 if depth == 16 else np.uint8)
    names = ["none", "sub", "up", "average", "paeth"]
    ft = (rng.integers(0, 5, h) if filters == "mixed"
          else np.full(h, names.index(filters))).tolist()
    palette = rng.integers(0, 256, (bound, 3), dtype=np.uint8) if ctype == 3 else None
    path = str(tmp_path / "f.png")
    _hand_png(path, img, depth, ctype, ft, palette)
    got = _same_as_imageio(path)
    if ctype == 3:
        np.testing.assert_array_equal(got, palette[img])
    elif kind == "rgb16":
        np.testing.assert_array_equal(got, (img >> 8).astype(np.uint8))
    else:
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("what", ["interlaced", "grey1", "ga16", "bad_crc", "truncated",
                                  "not_png"])
def test_read_png_raises_on_what_it_does_not_decode(tmp_path, what):
    path = str(tmp_path / "x.png")
    img = np.zeros((4, 5), np.uint8)
    field = {"interlaced": "interlace", "grey1": "bit depth", "ga16": "bit depth",
             "bad_crc": "CRC", "truncated": "IEND", "not_png": "signature"}[what]
    if what == "interlaced":
        _hand_png(path, img, 8, 0, [0] * 4, interlace=1)
    elif what == "grey1":
        _hand_png(path, img, 1, 0, [0] * 4)
    elif what == "ga16":
        _hand_png(path, np.zeros((4, 5, 2), np.uint16), 16, 4, [0] * 4)
    else:
        write_png(path, img)
        data = open(path, "rb").read()
        data = {"bad_crc": data[:20] + bytes([data[20] ^ 1]) + data[21:],
                "truncated": data[:-12], "not_png": b"GIF89a" + data[6:]}[what]
        open(path, "wb").write(data)
    with pytest.raises(ValueError, match=field) as err:
        read_png(path)
    assert path in str(err.value)
