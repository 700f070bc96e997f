"""Times dmnerf_torch/utils/jpeg.py against imageio (Pillow on libjpeg-turbo)
on the host this runs on: the median of 10 calls each of read_jpeg and
imageio.v2.imread on the same file, and of encode_jpeg and imageio.v2.imwrite
on the array it decodes to.

    python tests/torch_golden/jpeg/time_codec.py [FILE.jpg ...]

Without arguments: the 968x1296 fixture of this directory, and a 968x1296
frame with noise on it (a busier, larger file). Needs imageio and Pillow.
"""

import io
import os
import sys
import time

import imageio.v2 as imageio
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
from jpeg_fixtures import smooth_frame  # noqa: E402
from dmnerf_torch.utils.jpeg import encode_jpeg, read_jpeg  # noqa: E402


def median_ms(fn, n=10):
    fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def imwrite(img):
    bio = io.BytesIO()
    imageio.imwrite(bio, img, format="jpeg")
    return bio.getvalue()


def main(paths):
    cases = [(p, open(p, "rb").read()) for p in paths]
    if not cases:
        rng = np.random.default_rng(0)
        noisy = np.clip(smooth_frame(968, 1296).astype(np.int64)
                        + rng.integers(-40, 41, (968, 1296, 3)), 0, 255).astype(np.uint8)
        fixture = os.path.join(HERE, "default_968x1296.jpg")
        cases = [(fixture, open(fixture, "rb").read()), ("968x1296 with noise", imwrite(noisy))]
    for name, data in cases:
        img = imageio.imread(data)
        print(f"{name} ({len(data)} bytes, {img.shape}): read_jpeg "
              f"{median_ms(lambda: read_jpeg(data)):.2f} ms, imageio.imread "
              f"{median_ms(lambda: imageio.imread(data)):.2f} ms; encode_jpeg "
              f"{median_ms(lambda: encode_jpeg(img)):.2f} ms, imageio.imwrite "
              f"{median_ms(lambda: imwrite(img)):.2f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
