"""Lane-major 3-vector math on torch tensors.

Counterpart of ``raytracer795_tpu/utils/vec3.py``. A ``Vec3`` is three
``[N]`` component tensors instead of one ``[N, 3]`` tensor, and every
reduction keeps the JAX package's order (x before y before z), so the two
packages compute the same float32 bits for the same inputs.

Geometry never goes through a matmul: matrices are applied component by
component (``const_mat3_apply``), with the contraction order j = 0, 1, 2.

Division by a constant goes through ``cdiv``: on a CUDA tensor, PyTorch
turns ``x / python_scalar`` into ``x * (1 / scalar)``, which is not the
correctly rounded quotient the JAX package computes. A constant divided
by a tensor goes through ``rdiv`` for the same reason.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def cdiv(x, c):
    """``x / c`` correctly rounded for a Python or numpy scalar ``c``."""
    if isinstance(x, Vec3):
        return Vec3(cdiv(x.x, c), cdiv(x.y, c), cdiv(x.z, c))
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and CUDA's
    ``sqrtf`` give it. PyTorch's vectorized CPU kernel can be 1 ulp off;
    there the float64 root, rounded once to float32, is exact (53 bits
    >= 2 * 24 + 2, so the double rounding cannot err)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def rdiv(c, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` correctly rounded for a Python scalar ``c``: PyTorch's
    ``c / x`` is ``reciprocal(x) * c``, two roundings."""
    return torch.full((), float(c), dtype=x.dtype, device=x.device) / x


class Vec3(NamedTuple):
    """Three same-shaped component tensors."""

    x: Any
    y: Any
    z: Any

    @staticmethod
    def from_array(a):
        """Split an [..., 3] tensor into components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(shape, value, device, dtype=torch.float32):
        v = torch.full(shape, value, dtype=dtype, device=device)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, device, dtype=torch.float32):
        return Vec3.full(shape, 0.0, device, dtype)

    @staticmethod
    def ones(shape, device, dtype=torch.float32):
        return Vec3.full(shape, 1.0, device, dtype)

    def to_array(self):
        """Back to [..., 3] (once, at the film boundary)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @property
    def shape(self):
        return self.x.shape

    @property
    def device(self):
        return self.x.device

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        if isinstance(o, torch.Tensor):
            return Vec3(self.x / o, self.y / o, self.z / o)
        return cdiv(self, o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def vdot(a: Vec3, b: Vec3):
    """a . b, reduced x+y+z."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def vnorm2(v: Vec3):
    return v.x * v.x + v.y * v.y + v.z * v.z


def vnorm(v: Vec3):
    return sqrt(vnorm2(v))


def vnormalize(v: Vec3) -> Vec3:
    """v / |v| with no epsilon, as the reference divides."""
    return v * (1.0 / vnorm(v))


def vsafe_normalize(v: Vec3, eps: float = 1e-20) -> Vec3:
    return v * (1.0 / torch.clamp_min(vnorm(v), eps))


def vmasked_normalize(mask, v: Vec3) -> Vec3:
    """normalize(v) where ``mask``; the unit x vector elsewhere."""
    s = Vec3(torch.where(mask, v.x, 1.0), torch.where(mask, v.y, 0.0),
             torch.where(mask, v.z, 0.0))
    return s * (1.0 / vnorm(s))


def vwhere(mask, a, b) -> Vec3:
    """Componentwise where with an [N] mask. a/b may be scalars."""
    if not isinstance(a, Vec3):
        a = Vec3(a, a, a)
    if not isinstance(b, Vec3):
        b = Vec3(b, b, b)
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def vany_nan(v: Vec3):
    return torch.isnan(v.x) | torch.isnan(v.y) | torch.isnan(v.z)


def vscrub_nan(v: Vec3) -> Vec3:
    """Zero out vectors containing NaN (src/Scene.cpp:221-228 NanCheck)."""
    return vwhere(vany_nan(v), 0.0, v)


def vreflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction (src/Scene.cpp:35-38)."""
    wo = -d
    wr = -wo + n * (2.0 * vdot(n, wo))
    return vnormalize(wr)


def vorthonormal_u(v: Vec3) -> Vec3:
    """Orthonormal vector via the smallest-|component| trick
    (src/Helper.cpp:337-343), first-wins on ties."""
    ax, ay, az = torch.abs(v.x), torch.abs(v.y), torch.abs(v.z)
    pick0 = (ax <= ay) & (ax <= az)
    pick1 = ~pick0 & (ay <= az)
    pick2 = ~pick0 & ~pick1
    nl = Vec3(torch.where(pick0, 1.0, v.x), torch.where(pick1, 1.0, v.y),
              torch.where(pick2, 1.0, v.z))
    return vnormalize(vcross(v, nl))


class Mat3(NamedTuple):
    """Per-lane 3x3 matrix as three Vec3 rows."""

    r0: Vec3
    r1: Vec3
    r2: Vec3

    @staticmethod
    def identity_like(n, device):
        one = torch.ones((n,), device=device)
        zero = torch.zeros((n,), device=device)
        return Mat3(Vec3(one, zero, zero), Vec3(zero, one, zero),
                    Vec3(zero, zero, one))

    def apply(self, v: Vec3) -> Vec3:
        return Vec3(vdot(self.r0, v), vdot(self.r1, v), vdot(self.r2, v))


def mwhere(mask, a: Mat3, b: Mat3) -> Mat3:
    return Mat3(vwhere(mask, a.r0, b.r0), vwhere(mask, a.r1, b.r1),
                vwhere(mask, a.r2, b.r2))


def const_mat3_apply(m, v: Vec3) -> Vec3:
    """Apply one [>=3, >=3] matrix tensor to lane vectors, j = 0, 1, 2."""
    return Vec3(m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
                m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
                m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z)


def const_affine_apply(m4, p: Vec3) -> Vec3:
    """Affine 4x4 applied to lane points."""
    r = const_mat3_apply(m4, p)
    return Vec3(r.x + m4[0, 3], r.y + m4[1, 3], r.z + m4[2, 3])
