"""The procedural rock meshes of the test scenes, generated with numpy.

A copy of ``make_rock_ply`` and ``ensure_rock`` of
``tests/scenes/make_assets.py``, which imports the JAX package and so
cannot run where jax is absent. The bytes written are that script's bytes.
rock1800k.ply (1350 x 668 grid, 1,800,900 triangles, ~34 MB) is not
committed: ``ensure_rock`` writes it on first use.

The rock is a lat-long grid over a sphere with a multi-frequency
sinusoidal radius, 2 triangles a quad, written as binary little-endian PLY.
"""

from __future__ import annotations

import os

import numpy as np

ROCK1800K_GRID = (1350, 668)


def make_rock_ply(path: str, nu: int = 320, nv: int = 160):
    """Write the (nu x nv) rock to ``path``; returns (vertices, faces)."""
    uu = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    R = (1.0 + 0.14 * np.sin(6 * U) * np.sin(5 * V)
         + 0.07 * np.sin(13 * U + 1.0) * np.sin(11 * V + 2.0)
         + 0.035 * np.sin(27 * U + 3.0) * np.sin(23 * V))
    verts = np.stack([(R * np.sin(V) * np.cos(U)).ravel(),
                      (R * np.cos(V)).ravel(),
                      (R * np.sin(V) * np.sin(U)).ravel()],
                     axis=1).astype("<f4")

    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a = (i % nu) * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1)
    d = (i % nu) * nv + (j + 1)
    f1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    f2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    faces = np.empty((f1.shape[0] * 2, 3), "<i4")
    faces[0::2] = f1
    faces[1::2] = f2

    rec = np.zeros(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    rec["n"] = 3
    rec["v"] = faces
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % len(verts))
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face %d\n" % len(faces))
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(verts.tobytes())
        f.write(rec.tobytes())
    return len(verts), len(faces)


def ensure_rock(path: str, nu: int, nv: int) -> str:
    """Write the rock to ``path`` unless the file exists; returns ``path``.

    Writes to a temporary name first, so a reader never sees a partial
    file.
    """
    if not os.path.exists(path):
        tmp = f"{path}.tmp{os.getpid()}"
        make_rock_ply(tmp, nu=nu, nv=nv)
        os.replace(tmp, path)
    return path
