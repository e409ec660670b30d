"""Film output: LDR quantization, text PPM and PNG.

Counterpart of ``raytracer795_tpu/utils/image_io.py``. The PNG writer is
built on ``zlib`` and ``struct`` alone, so writing a frame needs no imaging
package. EXR output is not ported yet (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


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


def save_image(path: str, image: np.ndarray) -> None:
    """Name-dispatched writer mirroring Image::saveImage (src/Image.cpp:26-33)."""
    lower = path.lower()
    if lower.endswith(".ppm"):
        write_ppm(path, image)
    elif ".png" in lower:
        with open(path, "wb") as f:
            f.write(png_bytes(to_ldr(image)))
    else:
        raise NotImplementedError(
            f"EXR output ({path}) is not ported yet: ROADMAP queue 1 item 16")
