"""The JPEG fixtures of this directory and their checker: smooth_frame, the
source of the 968x1296 fixture, and jpeg_golden, which holds
dmnerf_torch/utils/jpeg.py to every fixture. make_fixtures.py writes the
fixtures; chip_smoke.py phase 15(a), tests/test_torch_jpeg.py and
tests/test_torch_cuda.py check them through jpeg_golden. Needs numpy and
dmnerf_torch alone (no Pillow), so it runs on the card machine.
"""

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def smooth_frame(H, W):
    """A smooth uint8 [H, W, 3] frame from integer arithmetic alone, the same
    on any machine: red along x, green along y, blue falling off radially."""
    y, x = np.mgrid[:H, :W].astype(np.int64)
    r = x * 255 // max(W - 1, 1)
    g = y * 255 // max(H - 1, 1)
    d2 = (2 * x - W) ** 2 + (2 * y - H) ** 2
    b = 255 - np.minimum(255, d2 * 255 // (W * W + H * H))
    return np.stack([r, g, b], -1).astype(np.uint8)


def jpeg_golden():
    """Every fixture of this directory decoded by utils/jpeg.py to the array
    that Pillow decoded (its sha256), and the source of every
    imageio-default fixture encoded to the fixture's bytes. Raises on any
    difference; returns (files decoded, files encoded)."""
    from dmnerf_torch.utils.jpeg import encode_jpeg, read_jpeg

    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    sources = np.load(os.path.join(HERE, "sources.npz"))
    bad, encoded = [], 0
    for name, m in sorted(manifest.items()):
        path = os.path.join(HERE, name)
        img = read_jpeg(path)
        got = [list(img.shape), str(img.dtype), hashlib.sha256(img.tobytes()).hexdigest()]
        if got != [m["shape"], m["dtype"], m["sha256"]]:
            bad.append(f"decode {name}: {got[:2]} {got[2][:12]}, want {m['shape']} "
                       f"{m['dtype']} {m['sha256'][:12]}")
        if m["source"]:
            src = (sources[name] if m["source"] == "sources.npz"
                   else smooth_frame(*m["shape"][:2]))
            with open(path, "rb") as f:
                if encode_jpeg(src) != f.read():
                    bad.append(f"encode {name}: the bytes differ from the file")
            encoded += 1
    if bad:
        raise AssertionError("the JPEG codec disagrees with its fixtures: " + "; ".join(bad))
    return len(manifest), encoded
