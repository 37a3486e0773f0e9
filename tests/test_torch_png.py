"""PyTorch port: the PNG reader and writer of ``utils/png.py`` against
Pillow, in both directions, for every colour type it handles and every row
filter, and ``to_luma`` against Pillow's ``convert("L")``."""

import numpy as np
import pytest
from PIL import Image

from cylinder_pose_estimation_tpu_torch.utils import png

MODES = {"L": (29, 37), "LA": (29, 37, 2), "RGB": (29, 37, 3), "RGBA": (29, 37, 4)}


def _image(mode: str, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, MODES[mode], dtype=np.uint8)


@pytest.mark.parametrize("filter_type", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_written_png_reads_back_in_pillow(tmp_path, mode, filter_type):
    img = _image(mode, filter_type)
    path = str(tmp_path / "x.png")
    png.write_png(path, img, filter_type)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(np.asarray(im.convert("L")), png.to_luma(png.read_png(path)))
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pillow_png_reads_here(tmp_path, mode):
    """Pillow picks a filter per row (all five occur on a smooth image with
    noise); the reader must give Pillow's pixels and luma."""
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 2) % 256
    noise = np.random.default_rng(1).integers(0, 4, (h, w))
    chans = MODES[mode][2] if len(MODES[mode]) == 3 else 1
    img = np.stack([(base + 40 * c + noise) % 256 for c in range(chans)], -1).astype(np.uint8)
    img = img[..., 0] if chans == 1 else img
    path = str(tmp_path / "p.png")
    Image.fromarray(img, mode).save(path)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.to_luma(got), np.asarray(im.convert("L")))


def test_luma_equals_pillow_on_every_channel_value(tmp_path):
    v = np.arange(256, dtype=np.uint8)
    r, g = np.meshgrid(v, v[::-1], indexing="ij")
    rgb = np.stack([r, g, (r // 2 + g // 3).astype(np.uint8)], -1)
    path = str(tmp_path / "rgb.png")
    Image.fromarray(rgb.astype(np.uint8), "RGB").save(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.to_luma(png.read_png(path)), np.asarray(im.convert("L")))


@pytest.mark.parametrize("mode", ["P", "I;16"])
def test_unsupported_pngs_raise(tmp_path, mode):
    path = str(tmp_path / "u.png")
    Image.fromarray(np.zeros((4, 4), np.uint16 if mode == "I;16" else np.uint8)).convert(mode).save(path)
    with pytest.raises(ValueError, match="8-bit"):
        png.read_png(path)


def test_write_rejects_non_uint8(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))
