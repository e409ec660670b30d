"""OpenEXR scanline reader (the read half of the JAX package's codec).

Counterpart of ``read_exr`` in ``raytracer795_tpu/utils/exr.py``: the
reference reads HDR textures through tinyexr (src/Helper.cpp:345-413),
and this reads the same files in numpy. Single-part scanline EXRs with
NONE, ZIPS or ZIP compression and half, float or uint channels, any RGB(A)
subset (or luminance Y alone) -> [H, W, 3] float32 in RGB order. The write
half is not ported yet (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_ZIPS, _COMP_ZIP = 0, 2, 3
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
