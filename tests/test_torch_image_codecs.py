"""The port's image readers against PIL and the JAX package's EXR reader.

The JAX package decodes PNG and JPEG textures with
``PIL.Image.convert("RGB")``; the port reads them with its own PNG reader
(``utils/image_io.read_png``) and baseline JPEG decoder (``utils/jpeg``),
which must give the same bytes. Its ``utils/exr.read_exr`` must equal the
JAX package's on the repo's EXRs and on files the JAX writer makes.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import conftest

torch.set_num_threads(1)


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def _seeded_image(h, w, channels, seed):
    """Gradients with noisy rows: smooth rows favour the predicting PNG
    filters and JPEG's low frequencies, noisy ones the rest."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 5 + y * 3) % 256, (x * x + y) % 256, (y * 7) % 256,
                     (x * y) % 256], -1)[..., :channels]
    noise = rng.integers(0, 256, (h, w, channels))
    img = np.where((y % 3 == 0)[..., None], noise, base).astype(np.uint8)
    return img if channels > 1 else img[..., 0]


def _png_filters(data: bytes):
    """The row filter types of a non-interlaced 8-bit PNG."""
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    return {raw[i * stride] for i in range(h)}


def _png_every_filter(img: np.ndarray) -> bytes:
    """An RGB PNG whose row y uses filter y % 5 (None, Sub, Up, Average,
    Paeth), encoded here as the PNG specification defines them."""
    h, w, _ = img.shape
    bpp, rows, prior = 3, [], np.zeros(3 * w, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        ftype = y % 5
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prior = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["checker.png", "normalmap.png",
                                  "bump.png"])
def test_png_reader_equals_pil_on_scene_pngs(name):
    from raytracer795_tpu_torch.utils.image_io import read_png

    path = os.path.join(conftest.SCENES, name)
    got = read_png(path)
    assert got.dtype == np.float32 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


def test_png_reader_equals_pil_on_every_filter(tmp_path):
    """Seeded PNGs in each 8-bit color type, written by PIL (which filters
    adaptively), and one written with every filter type in turn: the
    reader gives PIL's RGB bytes, and the files use all five filters."""
    from raytracer795_tpu_torch.utils.image_io import read_png

    used = set()
    for seed, (mode, channels) in enumerate((("RGB", 3), ("RGBA", 4),
                                             ("L", 1), ("LA", 2))):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(_seeded_image(37, 53, channels, seed), mode).save(
            path)
        with open(path, "rb") as f:
            used |= _png_filters(f.read())
        np.testing.assert_array_equal(read_png(path), _pil_rgb(path),
                                      err_msg=mode)
    path = str(tmp_path / "every_filter.png")
    with open(path, "wb") as f:
        f.write(_png_every_filter(_seeded_image(41, 29, 3, 9)))
    with open(path, "rb") as f:
        used |= _png_filters(f.read())
    np.testing.assert_array_equal(read_png(path), _pil_rgb(path))
    assert used == {0, 1, 2, 3, 4}


def test_jpeg_decoder_equals_pil_on_gradient_jpg():
    """tests/scenes/gradient.jpg (96x48 baseline JFIF, 4:2:0, two
    quantization tables) decodes to PIL's bytes exactly."""
    from raytracer795_tpu_torch.utils.jpeg import read_jpeg

    path = os.path.join(conftest.SCENES, "gradient.jpg")
    got = read_jpeg(path)
    assert got.dtype == np.float32 and got.shape == (48, 96, 3)
    np.testing.assert_array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("h,w,mode,options", [
    (37, 53, "RGB", {"subsampling": 2, "quality": 75}),    # 4:2:0, ragged
    (48, 96, "RGB", {"subsampling": 2, "quality": 95}),
    (33, 17, "RGB", {"subsampling": 0, "quality": 60}),    # 4:4:4
    (20, 31, "L", {"quality": 85}),                        # grayscale
    (64, 64, "RGB", {"subsampling": 2, "quality": 80,
                     "restart_marker_blocks": 3}),         # restarts
])
def test_jpeg_decoder_equals_pil_on_seeded_jpegs(h, w, mode, options,
                                                 tmp_path):
    from raytracer795_tpu_torch.utils.jpeg import read_jpeg

    img = _seeded_image(h, w, 3, h * w)
    if mode == "L":
        img = img[..., 0]
    path = str(tmp_path / "t.jpg")
    Image.fromarray(img, mode).save(path, "JPEG", **options)
    if "restart_marker_blocks" in options:
        with open(path, "rb") as f:
            assert b"\xff\xdd" in f.read()
    np.testing.assert_array_equal(read_jpeg(path), _pil_rgb(path))


def test_jpeg_decoder_refuses_progressive(tmp_path):
    from raytracer795_tpu_torch.utils.jpeg import read_jpeg

    path = str(tmp_path / "progressive.jpg")
    Image.fromarray(_seeded_image(16, 16, 3, 0)).save(path, "JPEG",
                                                      progressive=True)
    with pytest.raises(NotImplementedError, match="progressive.jpg"):
        read_jpeg(path)


def _exr_path(case, tmp_path):
    from raytracer795_tpu.utils.exr import write_exr

    if case == "sky.exr":
        return os.path.join(conftest.SCENES, case)
    if case == "envlight_hdr.exr":
        return os.path.join(conftest.GOLDENS, case)
    img = (np.random.default_rng(3).random((37, 23, 3)) * 50
           ).astype(np.float32)
    img[0, 0] = [0.0, 65000.0, 1e-5]
    path = str(tmp_path / f"{case}.exr")
    write_exr(path, img, compression=case)
    return path


@pytest.mark.parametrize("case", ["sky.exr", "envlight_hdr.exr", "none",
                                  "zip"])
def test_read_exr_equals_jax(case, tmp_path):
    """ZIP (sky.exr), the reference renderer's NONE half B/G/R output
    (envlight_hdr.exr), and the JAX writer's NONE and ZIP files."""
    from raytracer795_tpu.utils.exr import read_exr as jax_read_exr

    from raytracer795_tpu_torch.utils.exr import read_exr

    path = _exr_path(case, tmp_path)
    want = jax_read_exr(path)
    got = read_exr(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_image_routes_by_kind(tmp_path):
    """The loader's reader for each kind of file, and a refusal for a kind
    it has none for."""
    from raytracer795_tpu_torch.scene.loader import _load_image

    for name in ("checker.png", "gradient.jpg"):
        path = os.path.join(conftest.SCENES, name)
        np.testing.assert_array_equal(_load_image(path), _pil_rgb(path))
    assert _load_image(os.path.join(conftest.SCENES, "sky.exr")).shape == \
        (64, 128, 3)
    path = str(tmp_path / "t.bmp")
    buf = io.BytesIO()
    Image.fromarray(_seeded_image(4, 4, 3, 0)).save(buf, "BMP")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    with pytest.raises(NotImplementedError, match="t.bmp"):
        _load_image(path)
