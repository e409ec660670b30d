"""OpenEXR scanline codec in numpy.

Counterpart of ``raytracer795_tpu/utils/exr.py``: the reference reads HDR
textures and writes HDR renders through tinyexr (src/Helper.cpp:345-413).

- ``read_exr``: single-part scanline EXRs with NONE, ZIPS or ZIP
  compression and half, float or uint channels, any RGB(A) subset (or
  luminance Y alone) -> [H, W, 3] float32 in RGB order.
- ``write_exr``: three half-float channels stored B, G, R (the reference's
  output contract, src/Helper.cpp:392-404), NONE or ZIP compressed; the
  bytes are the JAX package's for the same image.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3
_COMPRESSION = {"none": _COMP_NONE, "zip": _COMP_ZIP}
_DTYPES = {_PT_HALF: np.dtype("<f2"), _PT_FLOAT: np.dtype("<f4"),
           _PT_UINT: np.dtype("<u4")}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def _unpredict_and_interleave(raw: bytes) -> bytes:
    """Undo OpenEXR's ZIP predictor (t[i] = t[i-1] + raw[i] - 128) and its
    byte split (first half -> even positions, second half -> odd)."""
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int64).copy()
    d[1:] -= 128
    d = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty(len(d), dtype=np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read an EXR image, returning [H, W, 3] float32 in RGB order."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR not supported")
    off = 8

    channels = []  # (name, pixel_type), in stored (alphabetical) order
    compression = _COMP_NONE
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels" and atype == "chlist":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 4 + 1 + 3 + 4 + 4  # type, pLinear, reserved, xSamp, ySamp
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if data_window is None:
        raise ValueError(f"{path}: EXR missing dataWindow")
    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1

    if compression == _COMP_ZIP:
        lines_per_block = 16
    elif compression in (_COMP_NONE, _COMP_ZIPS):
        lines_per_block = 1
    else:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")

    n_blocks = -(-height // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)
    planes: Dict[str, np.ndarray] = {
        c: np.zeros((height, width), np.float32) for c, _ in channels}
    line_bytes = sum(_DTYPES[pt].itemsize * width for _, pt in channels)

    for boff in offsets:
        y, dsize = struct.unpack_from("<ii", buf, boff)
        raw = buf[boff + 8: boff + 8 + dsize]
        y0 = y - ymin
        nlines = min(lines_per_block, height - y0)
        # a block that did not shrink is stored raw (OpenEXR convention)
        if compression != _COMP_NONE and dsize < line_bytes * nlines:
            raw = _unpredict_and_interleave(zlib.decompress(raw))
        p = 0
        for li in range(nlines):
            for cname, ptype in channels:
                dt = _DTYPES[ptype]
                planes[cname][y0 + li] = np.frombuffer(raw, dt, width, p)
                p += dt.itemsize * width

    out = np.zeros((height, width, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in planes:
            out[..., i] = planes[c]
        elif "Y" in planes:  # luminance-only fallback
            out[..., i] = planes["Y"]
    return out


def _predict_and_deinterleave(raw: bytes) -> bytes:
    """Inverse of ``_unpredict_and_interleave``: split the bytes (even
    positions first, then odd) and store each as its difference from the
    one before, plus 128."""
    d = np.frombuffer(raw, dtype=np.uint8)
    half = (len(d) + 1) // 2
    t = np.empty(len(d), dtype=np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    e = t.astype(np.int16)
    e[1:] = e[1:] - t[:-1].astype(np.int16) + 128
    return (e & 0xFF).astype(np.uint8).tobytes()


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path: str, image: np.ndarray, compression: str = "none"
              ) -> None:
    """Write [H, W, 3] float RGB as a half-float B/G/R scanline EXR.

    ``compression`` "none" (tinyexr's default, one scanline a block) or
    "zip" (16 scanlines a block, OpenEXR's predictor and zlib; a block that
    does not shrink is stored raw).
    """
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    comp_id = _COMPRESSION[compression]
    chlist = b"".join(c + b"\x00" + struct.pack("<iB3xii", _PT_HALF, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", bytes([comp_id])),
        _attr("dataWindow", "box2i", box),
        _attr("displayWindow", "box2i", box),
        _attr("lineOrder", "lineOrder", bytes([0])),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    bgr = img.astype("<f2")[..., ::-1]
    lines_per_block = 16 if comp_id == _COMP_ZIP else 1
    blocks = []
    for y0 in range(0, h, lines_per_block):
        # per scanline, per channel (B, G, R), the row's half floats
        raw = b"".join(bgr[y].transpose(1, 0).tobytes()
                       for y in range(y0, min(y0 + lines_per_block, h)))
        if comp_id == _COMP_ZIP:
            packed = zlib.compress(_predict_and_deinterleave(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        blocks.append((y0, packed))

    out = bytearray(struct.pack("<ii", _MAGIC, 2) + header)
    offset = len(out) + 8 * len(blocks)
    for _, packed in blocks:
        out += struct.pack("<Q", offset)
        offset += 8 + len(packed)
    for y0, packed in blocks:
        out += struct.pack("<ii", y0, len(packed)) + packed
    with open(path, "wb") as f:
        f.write(bytes(out))
