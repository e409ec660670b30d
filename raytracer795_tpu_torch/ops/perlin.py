"""Perlin noise with the reference's exact tables and weight function.

Counterpart of ``raytracer795_tpu/ops/perlin.py`` (contract: src/Perlin.cpp):
the 16-entry gradient table and the hardcoded shuffle, the weight
-6|x|^5 + 15|x|^4 - 10|x|^3 + 1, the lattice hash with a non-negative mod,
the linear/absval noise conversions, and the forward-difference bump
gradient with eps = 0.001.

Bit parity with the JAX package: ``x**n`` there is ``lax.integer_pow``, a
chain of multiplies by squaring (x^3 = x * x^2, x^4 = x^2 * x^2,
x^5 = x * x^4), which ``_weight`` writes out in the same order (a libm
``pow`` would round differently), and the gradient keeps its correctly
rounded division by eps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import Vec3, cdiv

_TABLE = np.array([
    [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
    [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
    [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    [1, 1, 0], [-1, 1, 0], [0, -1, 1], [0, -1, -1],
], np.float32)

_SHUFFLED = np.array([12, 7, 15, 6, 11, 0, 4, 9, 13, 3, 14, 8, 2, 5, 1, 10],
                     np.int64)

_EPS = 0.001


def _weight(x: torch.Tensor) -> torch.Tensor:
    """-6|x|^5 + 15|x|^4 - 10|x|^3 + 1, with integer_pow's multiplies."""
    x = torch.abs(x)
    x2 = x * x
    x4 = x2 * x2
    return ((-6.0) * (x * x4)) + (15.0 * x4) - (10.0 * (x * x2)) + 1.0


@functools.lru_cache(maxsize=None)
def _tables(dev: torch.device):
    """The gradient table and the shuffle on ``dev``, copied there once."""
    return (torch.from_numpy(_TABLE).to(dev),
            torch.from_numpy(_SHUFFLED).to(dev))


def _hash(lx, ly, lz, shuffled) -> torch.Tensor:
    """Lattice int components -> gradient index (src/Perlin.cpp:86-97)."""
    h = shuffled[torch.remainder(lz, 16)]
    h = shuffled[torch.remainder(ly + h, 16)]
    return shuffled[torch.remainder(lx + h, 16)]


def perlin(p: Vec3, scale, nc: int) -> torch.Tensor:
    """Noise value for lane points p (src/Perlin.cpp:52-84)."""
    table, shuffled = _tables(p.x.device)
    px, py, pz = p.x * scale, p.y * scale, p.z * scale
    bx = torch.floor(px).long()
    by = torch.floor(py).long()
    bz = torch.floor(pz).long()
    value = torch.zeros_like(px)
    for i in range(2):
        for j in range(2):
            for k in range(2):
                lx, ly, lz = bx + i, by + j, bz + k
                g = table[_hash(lx, ly, lz, shuffled)]
                rx = px - lx.to(px.dtype)
                ry = py - ly.to(px.dtype)
                rz = pz - lz.to(px.dtype)
                w = _weight(rx) * _weight(ry) * _weight(rz)
                value = value + (g[:, 0] * rx + g[:, 1] * ry
                                 + g[:, 2] * rz) * w
    if nc == T.NC_LINEAR:
        value = (value + 1.0) * 0.5
    elif nc == T.NC_ABSVAL:
        value = torch.abs(value)
    return value


def perlin_gradient(p: Vec3, scale, nc: int) -> Vec3:
    """Forward-difference gradient, eps = 0.001 (src/Perlin.cpp:36-50),
    kept finite-difference for bit parity with the reference's bump."""
    v0 = perlin(p, scale, nc)
    gx = cdiv(perlin(Vec3(p.x + _EPS, p.y, p.z), scale, nc) - v0, _EPS)
    gy = cdiv(perlin(Vec3(p.x, p.y + _EPS, p.z), scale, nc) - v0, _EPS)
    gz = cdiv(perlin(Vec3(p.x, p.y, p.z + _EPS), scale, nc) - v0, _EPS)
    return Vec3(gx, gy, gz)
