"""dmnerf_torch/utils/jpeg.py (the C++ codec of dmnerf_torch/native/jpeg.cpp)
against Pillow on libjpeg-turbo, through imageio as the JAX package calls it:

- read_jpeg gives imageio.v2.imread's array to the bit: sizes 1x1 to
  968x1296, 4:4:4, 4:2:2, 4:2:0 and greyscale, qualities 50, 75 and 95,
  with and without restart markers; OpenCV's 4:4:0 and 4:1:1 files; and a
  hypothesis case over random sizes, content, sampling and quality;
- write_jpeg writes imageio.v2.imwrite's bytes, at its default quality and
  at others;
- each refused kind of file raises a ValueError that names the file and the
  marker; without g++ both raise a RuntimeError that names it;
- the fixtures of tests/torch_golden/jpeg (which chip_smoke.py phase 15
  checks on the card, through the same jpeg_fixtures.jpeg_golden) decode and encode exactly.
"""

import hashlib
import io
import json
import os
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "torch_golden", "jpeg"))

import jpeg_fixtures  # noqa: E402
from dmnerf_torch import native  # noqa: E402
from dmnerf_torch.utils.jpeg import encode_jpeg, read_jpeg, write_jpeg  # noqa: E402

SIZES = [(1, 1), (7, 9), (17, 33), (480, 640), (968, 1296)]
SAMPLING = {"444": 0, "422": 1, "420": 2, "grey": None}


def _content(H, W, grey, seed, kind="mixed"):
    """uint8 [H, W, 3] or [H, W]: a smooth frame with noise on it (mixed),
    noise alone, or the smooth frame alone."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    else:
        img = jpeg_fixtures.smooth_frame(H, W)
        if kind == "mixed":
            img = np.clip(img.astype(np.int64) + rng.integers(-40, 41, img.shape),
                          0, 255).astype(np.uint8)
    return img[..., 1].copy() if grey else img


def _pillow(img, **kw):
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", **kw)
    return bio.getvalue()


def _imageio(img, **kw):
    bio = io.BytesIO()
    imageio.imwrite(bio, img, format="jpeg", **kw)
    return bio.getvalue()


def _same(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{int((got != want).sum())} samples differ"


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_jpeg_equals_imageio(size, sampling, quality, restart, tmp_path):
    img = _content(*size, sampling == "grey", seed=size[0] * 7 + quality)
    kw = {"quality": quality}
    if SAMPLING[sampling] is not None:
        kw["subsampling"] = SAMPLING[sampling]
    if restart:
        kw["restart_marker_blocks"] = 3
    path = tmp_path / "a.jpg"
    path.write_bytes(_pillow(img, **kw))
    if restart:
        assert b"\xff\xdd" in path.read_bytes()          # a DRI segment
    _same(read_jpeg(str(path)), imageio.imread(str(path)))
    _same(read_jpeg(path.read_bytes()), imageio.imread(str(path)))


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("factor", ["440", "411", "420"])
@pytest.mark.parametrize("size", [(5, 3), (21, 30), (97, 130)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_jpeg_equals_imageio_on_opencv_files(size, factor, kind):
    """Luma sampled 1x2 (4:4:0) and 4x1 (4:1:1), which Pillow does not write,
    with a restart interval of 2 MCUs."""
    img = _content(*size, False, seed=3, kind=kind)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")])
    assert ok
    _same(read_jpeg(enc.tobytes()), imageio.imread(enc.tobytes()))


@settings(max_examples=60, deadline=None)
@given(H=st.integers(1, 90), W=st.integers(1, 90), sampling=st.sampled_from(sorted(SAMPLING)),
       quality=st.integers(1, 100), kind=st.sampled_from(["noise", "smooth", "mixed"]),
       restart=st.integers(0, 4), seed=st.integers(0, 2 ** 16))
def test_read_jpeg_equals_imageio_on_random_files(H, W, sampling, quality, kind, restart, seed):
    img = _content(H, W, sampling == "grey", seed, kind)
    kw = {"quality": quality}
    if SAMPLING[sampling] is not None:
        kw["subsampling"] = SAMPLING[sampling]
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pillow(img, **kw)
    _same(read_jpeg(data), imageio.imread(data))


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("size", SIZES + [(31, 47), (968, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_jpeg_writes_imageios_bytes(size, grey, tmp_path):
    img = _content(*size, grey, seed=size[1])
    write_jpeg(str(tmp_path / "a.jpg"), img)
    imageio.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    _same(read_jpeg(str(tmp_path / "a.jpg")), imageio.imread(str(tmp_path / "b.jpg")))


@pytest.mark.parametrize("quality", [1, 10, 50, 90, 95, 100])
@pytest.mark.parametrize("grey", [False, True])
def test_write_jpeg_at_other_qualities(quality, grey):
    img = _content(40, 56, grey, seed=quality)
    assert encode_jpeg(img, quality) == _imageio(img, quality=quality)


@settings(max_examples=40, deadline=None)
@given(H=st.integers(1, 70), W=st.integers(1, 70), grey=st.booleans(),
       kind=st.sampled_from(["noise", "smooth", "mixed"]), seed=st.integers(0, 2 ** 16))
def test_write_jpeg_writes_imageios_bytes_on_random_images(H, W, grey, kind, seed):
    img = _content(H, W, grey, seed, kind)
    assert encode_jpeg(img) == _imageio(img)


def test_write_jpeg_rejects_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 1), np.uint8), np.zeros(4, np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            write_jpeg(str(tmp_path / "a.jpg"), bad)
    assert not (tmp_path / "a.jpg").exists()


def _segments(data):
    """(offset, marker) of each marker segment before the first SOS."""
    out, p = [], 2
    while True:
        m = data[p + 1]
        out.append((p, m))
        if m == 0xDA:
            return out
        p += 2 + int.from_bytes(data[p + 2:p + 4], "big")


def _with_marker(data, old, new):
    p = [p for p, m in _segments(data) if m == old][0]
    return data[:p + 1] + bytes([new]) + data[p + 2:]


def _refused(kind):
    img = _content(24, 40, False, seed=1)
    base = _pillow(img, quality=75)
    if kind == "progressive":
        return _pillow(img, quality=75, progressive=True), "0xFFC2"
    if kind == "lossless":
        return _with_marker(base, 0xC0, 0xC3), "0xFFC3"
    if kind == "arithmetic":
        return _with_marker(base, 0xC0, 0xC9), "0xFFC9"
    if kind == "12-bit":
        p = [p for p, m in _segments(base) if m == 0xC0][0]
        return base[:p + 4] + bytes([12]) + base[p + 5:], "0xFFC0"
    if kind == "cmyk":
        bio = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(bio, "JPEG")
        return bio.getvalue(), "0xFFEE"
    if kind == "adobe":
        app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x01"
        return base[:2] + app14 + base[2:], "0xFFEE"
    if kind == "truncated":
        return base[:-40], "0xFFD9"                    # inside the scan data
    if kind == "truncated header":
        p = [p for p, m in _segments(base) if m == 0xC4][1]
        return base[:p + 10], "0xFFC4"                  # inside the second DHT
    if kind == "bad marker":
        return _with_marker(base, 0xDB, 0x02), "0xFF02"
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["progressive", "lossless", "arithmetic", "12-bit", "cmyk",
                                  "adobe", "truncated", "truncated header", "bad marker"])
def test_refusals_name_the_file_and_the_marker(kind, tmp_path):
    data, marker = _refused(kind)
    path = tmp_path / f"{kind.replace(' ', '_')}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError) as e:
        read_jpeg(str(path))
    assert str(path) in str(e.value) and marker in str(e.value), str(e.value)
    with pytest.raises(ValueError, match="<bytes>"):
        read_jpeg(data)


def test_without_gpp_the_codec_raises_naming_it(tmp_path, monkeypatch):
    """No fallback: with no g++ on PATH and nothing built, read_jpeg and
    write_jpeg raise a RuntimeError that names g++."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cached", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    data = _pillow(_content(8, 8, False, seed=0))
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        read_jpeg(data)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        write_jpeg(str(tmp_path / "a.jpg"), _content(8, 8, False, seed=0))


def test_the_codec_library_is_named_by_its_sources_hash(tmp_path, monkeypatch):
    """The .so carries the first 8 hex digits of jpeg.cpp's sha256, so a
    library under another name (a stale or copied build) is never loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_cached", {})
    os.makedirs(tmp_path, exist_ok=True)
    stale = tmp_path / "_jpeg_native.cpython-312-x86_64-linux-gnu.so"
    stale.write_bytes(b"not a library")
    with open(os.path.join(REPO, "dmnerf_torch", "native", "jpeg.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    mod = native.require("_jpeg_native", "jpeg.cpp")
    assert os.path.basename(mod.__file__).startswith(f"_jpeg_native_{digest}.")
    assert os.path.dirname(mod.__file__) == str(tmp_path)
    assert read_jpeg(_pillow(_content(8, 8, False, seed=0))).shape == (8, 8, 3)


def test_golden_fixtures_are_pillows_and_the_codec_matches_them():
    """The fixtures that phase 15 and tests/test_torch_cuda.py check on the
    card: the manifest holds what imageio decodes from each file here, and
    the codec decodes and encodes them exactly (jpeg_fixtures.jpeg_golden)."""
    with open(os.path.join(jpeg_fixtures.HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for name, m in manifest.items():
        img = imageio.imread(os.path.join(jpeg_fixtures.HERE, name))
        assert [list(img.shape), str(img.dtype), hashlib.sha256(img.tobytes()).hexdigest()] == \
            [m["shape"], m["dtype"], m["sha256"]], name
    assert jpeg_fixtures.jpeg_golden() == (len(manifest), 3)
    total = sum(os.path.getsize(os.path.join(jpeg_fixtures.HERE, f))
                for f in os.listdir(jpeg_fixtures.HERE))
    assert total < 300_000
