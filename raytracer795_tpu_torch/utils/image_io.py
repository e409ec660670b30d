"""Film output: LDR quantization, text PPM, PNG and EXR; and the PNG reader.

Counterpart of ``raytracer795_tpu/utils/image_io.py``. The PNG writer and
reader are built on ``zlib`` and ``struct`` alone, and EXR goes through
``utils/exr.py``, so neither writing a frame nor reading a texture needs an
imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracer795_tpu_torch.utils import exr


def to_ldr(image: np.ndarray) -> np.ndarray:
    """Clamp to 255 and truncate to uint8 (src/Image.cpp:64-69,95)."""
    return np.clip(np.asarray(image), 0, 255).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Text P3 PPM in the layout of src/Image.cpp:62-103."""
    ldr = to_ldr(image)
    h, w = ldr.shape[:2]
    with open(path, "w") as f:
        f.write("P3\n")
        f.write(f"{w} {h}\n")
        f.write("255\n")
        for y in range(h):
            f.write(" ".join(str(int(v)) for v in ldr[y].reshape(-1)))
            f.write(" \n")


def read_ppm(path: str) -> np.ndarray:
    """Read a text P3 PPM into [H, W, 3] float32."""
    with open(path) as f:
        tok = f.read().split()
    if tok[0] != "P3":
        raise ValueError(f"not a text PPM: {path}")
    w, h = int(tok[1]), int(tok[2])
    data = np.asarray(tok[4:4 + w * h * 3], dtype=np.float32)
    return data.reshape(h, w, 3)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def png_bytes(ldr: np.ndarray) -> bytes:
    """8-bit RGB PNG of an [H, W, 3] uint8 frame (filter 0 on every row)."""
    ldr = np.ascontiguousarray(ldr, np.uint8)
    h, w = ldr.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = ldr.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # gray, RGB, gray+alpha, RGBA


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:            # Sub: a running sum per channel
            cur = (line.reshape(-1, bpp).cumsum(0) & 0xFF).reshape(-1)
        elif ftype == 2:
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):       # Average, Paeth: read the new bytes
            cur = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype} does not exist")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] float32 byte values of an 8-bit, non-interlaced gray,
    gray+alpha, RGB or RGBA PNG: what ``PIL.Image.convert("RGB")`` gives
    (gray is replicated, alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: only 8-bit, non-interlaced gray, gray+alpha, RGB and "
            f"RGBA PNGs are read (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace})")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw[:h * (stride + 1)].reshape(h, stride + 1), h, stride,
                   bpp).reshape(h, w, bpp)
    rgb = px[..., :3] if bpp >= 3 else np.repeat(px[..., :1], 3, axis=2)
    return rgb.astype(np.float32)


def save_image(path: str, image: np.ndarray) -> None:
    """Name-dispatched writer mirroring Image::saveImage (src/Image.cpp:26-33)."""
    lower = path.lower()
    if lower.endswith(".ppm"):
        write_ppm(path, image)
    elif ".png" in lower:
        with open(path, "wb") as f:
            f.write(png_bytes(to_ldr(image)))
    else:
        exr.write_exr(path, np.asarray(image, np.float32))
