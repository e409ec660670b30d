"""Minimal PLY reader (happly-equivalent for the features the scenes use).

The reference loads meshes through happly (src/Parser.h:1049-1099): vertex
positions, optional per-vertex ``u``/``v`` texture coordinates, and face index
lists (quads are split into two triangles by the caller). This reader covers
ascii 1.0 and binary_little_endian 1.0 with numeric property types, which is
what the course scene PLYs use.

Host numpy, the same reader as ``raytracer795_tpu/scene/ply.py``: that
package's modules import jax, so the port carries its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PlyData:
    vertices: np.ndarray            # [V, 3] float64
    uv: Optional[np.ndarray]        # [V, 2] float64 or None
    faces: List[np.ndarray]         # list of index arrays (len 3 or 4+)


def _parse_header(data: bytes):
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    fmt = None
    elements = []  # (name, count, [(prop_name, kind, dtype/list dtypes)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], "list", (_TYPES[tok[2]], _TYPES[tok[3]])))
            else:
                elements[-1][2].append((tok[2], "scalar", _TYPES[tok[1]]))
    return fmt, elements, body


def _read_ascii(elements, body: bytes):
    tokens = body.split()
    pos = 0
    out: Dict[str, Dict[str, list]] = {}
    for name, count, props in elements:
        store: Dict[str, list] = {p[0]: [] for p in props}
        for _ in range(count):
            for pname, kind, dt in props:
                if kind == "list":
                    n = int(tokens[pos]); pos += 1
                    store[pname].append([float(tokens[pos + i]) for i in range(n)])
                    pos += n
                else:
                    store[pname].append(float(tokens[pos])); pos += 1
        out[name] = store
    return out


def _read_binary_le(elements, body: bytes):
    out: Dict[str, Dict[str, list]] = {}
    off = 0
    for name, count, props in elements:
        store: Dict[str, list] = {p[0]: [] for p in props}
        fixed = all(k == "scalar" for _, k, _ in props)
        if fixed:
            # vectorized fast path
            dt = np.dtype([(p[0], "<" + p[2]) for p in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            for pname, _, _ in props:
                store[pname] = arr[pname].astype(np.float64).tolist()
        else:
            for _ in range(count):
                for pname, kind, dt in props:
                    if kind == "list":
                        cdt = np.dtype("<" + dt[0])
                        n = int(np.frombuffer(body, cdt, 1, off)[0]); off += cdt.itemsize
                        idt = np.dtype("<" + dt[1])
                        vals = np.frombuffer(body, idt, n, off); off += idt.itemsize * n
                        store[pname].append(vals.astype(np.float64).tolist())
                    else:
                        sdt = np.dtype("<" + dt)
                        store[pname].append(float(np.frombuffer(body, sdt, 1, off)[0]))
                        off += sdt.itemsize
        out[name] = store
    return out


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    fmt, elements, body = _parse_header(data)
    if fmt == "ascii":
        tables = _read_ascii(elements, body)
    elif fmt == "binary_little_endian":
        tables = _read_binary_le(elements, body)
    else:
        raise ValueError(f"unsupported PLY format {fmt!r} in {path}")

    vt = tables.get("vertex", {})
    verts = np.stack(
        [np.asarray(vt["x"]), np.asarray(vt["y"]), np.asarray(vt["z"])], axis=-1
    ).astype(np.float64)
    uv = None
    if "u" in vt and "v" in vt:
        uv = np.stack([np.asarray(vt["u"]), np.asarray(vt["v"])], axis=-1).astype(np.float64)

    faces: List[np.ndarray] = []
    ft = tables.get("face", {})
    for key in ("vertex_indices", "vertex_index"):
        if key in ft:
            faces = [np.asarray(ix, dtype=np.int64) for ix in ft[key]]
            break
    return PlyData(vertices=verts, uv=uv, faces=faces)
