"""Writes the JPEG fixtures of this directory with Pillow (through imageio
and PIL) and OpenCV, and records what Pillow decodes from each.

    python tests/torch_golden/jpeg/make_fixtures.py

Needs numpy, imageio, Pillow and OpenCV (the JAX package's environment).
Each fixture is a .jpg; manifest.json holds, per file, the shape, dtype and
sha256 of imageio.v2.imread's array, and, for the files that
imageio.v2.imwrite wrote with its defaults, where the written array comes
from: sources.npz (small random arrays) or jpeg_fixtures.py::smooth_frame
(the 968x1296 frame). dmnerf_torch/utils/jpeg.py must decode each file to
that array and encode each source to the file's bytes
(jpeg_fixtures.py::jpeg_golden, which chip_smoke.py phase 15,
tests/test_torch_jpeg.py and tests/test_torch_cuda.py call).
"""

import hashlib
import io
import json
import os

import cv2
import imageio.v2 as imageio
import numpy as np
from PIL import Image

from jpeg_fixtures import HERE, smooth_frame


def main():
    rng = np.random.default_rng(9)
    noise = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    small = smooth_frame(48, 64)
    sources, manifest = {}, {}

    def pillow(name, img, **kw):
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, "JPEG", **kw)
        return bio.getvalue()

    def default(name, img):
        bio = io.BytesIO()
        imageio.imwrite(bio, img, format="jpeg")
        return bio.getvalue()

    files = {
        # imageio.v2.imwrite's defaults: 4:2:0 at quality 75, and greyscale
        "default_420_17x33.jpg": (default, noise(17, 33, 3), "sources.npz"),
        "default_grey_19x29.jpg": (default, noise(19, 29), "sources.npz"),
        "default_968x1296.jpg": (default, smooth_frame(968, 1296), "smooth_frame"),
        # what else Pillow writes
        "pillow_444_7x9.jpg": (lambda n, a: pillow(n, a, quality=75, subsampling=0),
                               noise(7, 9, 3), None),
        "pillow_422_31x45.jpg": (lambda n, a: pillow(n, a, quality=75, subsampling=1),
                                 noise(31, 45, 3), None),
        "pillow_420_q50_23x37.jpg": (lambda n, a: pillow(n, a, quality=50),
                                     small[:23, :37], None),
        "pillow_420_q95_40x56.jpg": (lambda n, a: pillow(n, a, quality=95),
                                     small[:40, :56], None),
        "pillow_dri_420_48x64.jpg": (lambda n, a: pillow(n, a, quality=75,
                                                         restart_marker_blocks=3),
                                     small, None),
        "pillow_grey_q90_1x1.jpg": (lambda n, a: pillow(n, a, quality=90), noise(1, 1), None),
        # luma 1x2 (4:4:0), which Pillow does not write
        "opencv_440_21x30.jpg": (lambda n, a: cv2.imencode(".jpg", a[..., ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])[1].tobytes(), small[:21, :30], None),
    }
    for name, (write, img, source) in files.items():
        data = write(name, img)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        dec = imageio.imread(data)
        manifest[name] = {"shape": list(dec.shape), "dtype": str(dec.dtype),
                          "sha256": hashlib.sha256(np.ascontiguousarray(dec).tobytes())
                          .hexdigest(), "source": source}
        if source == "sources.npz":
            sources[name] = img
    np.savez_compressed(os.path.join(HERE, "sources.npz"), **sources)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} fixtures: "
          f"{sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))} bytes")


if __name__ == "__main__":
    main()
