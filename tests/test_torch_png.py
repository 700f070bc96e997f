"""dmnerf_torch/utils/png.py: what it writes reads back equal through imageio."""

import imageio.v2 as imageio
import numpy as np
import pytest

from dmnerf_torch.utils.png import write_png


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (1, 1), (64, 33, 3)])
def test_png_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = imageio.imread(path)
    assert back.dtype == np.uint8 and back.shape == img.shape
    np.testing.assert_array_equal(back, img)


def test_png_rejects_other_layouts(tmp_path):
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), np.zeros((4, 4, 4), np.uint8))
