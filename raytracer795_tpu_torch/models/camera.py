"""Camera ray generation (lane-major Vec3 output).

Counterpart of ``raytracer795_tpu/models/camera.py``: tile-swizzled lane
order, center-of-pixel primary rays (src/Camera.cpp:63-72), and jittered
sample rays with depth of field and motion-blur time, drawn from the RNG
that matches ``jax.random`` (``utils/rng.py``). The frames trace per-lane
pixels (``*_at``); ``primary_rays`` and ``sample_rays_range`` give a band
of rows in image-row-major order, for the profiler and callers of the JAX
package's names.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer795_tpu_torch.ops.intersect import Rays
from raytracer795_tpu_torch.scene.types import Camera
from raytracer795_tpu_torch.utils import rng
from raytracer795_tpu_torch.utils.vec3 import (Vec3, cdiv, rdiv, vdot,
                                               vnormalize)

TILE_W = 64
TILE_H = 64


def band_pixels(nx: int, n_rows: int, device, tile_w: int = TILE_W,
                tile_h: int = TILE_H):
    """Lane -> (px, py_in_band) in tile-swizzled order, int32 on ``device``.

    Lanes enumerate the band 64x64 pixel tile by tile (row-major inside a
    tile, edge tiles clipped). Neighbouring lanes are neighbouring pixels,
    so a warp's 32 rays, and the BVH walks they take, stay coherent. The
    JAX package's integer arithmetic, on the device: a band needs no host
    index work.
    """
    tile_h = min(tile_h, max(1, n_rows))
    lane = torch.arange(n_rows * nx, dtype=torch.int64, device=device)
    row_band = nx * tile_h                      # lanes per tile-row
    tr = lane // row_band
    r = lane - tr * row_band
    th_eff = torch.clamp_max(n_rows - tr * tile_h, tile_h)  # clipped bottom
    tile_area = tile_w * th_eff
    tc = r // tile_area
    c = r - tc * tile_area
    tw_eff = torch.clamp_max(nx - tc * tile_w, tile_w)      # clipped right
    px = tc * tile_w + c % tw_eff
    py = tr * tile_h + c // tw_eff
    return px.to(torch.int32), py.to(torch.int32)


def band_unswizzle_index(px: torch.Tensor, py: torch.Tensor, nx: int):
    """``band_flat[idx] = band_output`` undoes band_pixels' lane order."""
    return py.long() * nx + px.long()


def primary_rays_at(cam: Camera, px: torch.Tensor, py: torch.Tensor) -> Rays:
    """Center-of-pixel rays for per-lane int32 pixel coords (frame space)."""
    nx, ny = cam.nx, cam.ny
    x = cdiv(px + 0.5, nx)
    y = cdiv(py + 0.5, ny)
    ub = cam.left + (cam.right_edge - cam.left) * x         # [N]
    vb = cam.top - (cam.top - cam.bottom) * y               # [N]
    pos = np.asarray(cam.pos, np.float32)
    gaze = np.asarray(cam.gaze, np.float32)
    right = np.asarray(cam.right, np.float32)
    up = np.asarray(cam.up, np.float32)
    near = np.float32(cam.near_distance)
    base = [float(pos[k] + gaze[k] * near) for k in range(3)]   # f32 host
    m = Vec3(base[0] + ub * float(right[0]) + vb * float(up[0]),
             base[1] + ub * float(right[1]) + vb * float(up[1]),
             base[2] + ub * float(right[2]) + vb * float(up[2]))
    d = vnormalize(m - Vec3(float(pos[0]), float(pos[1]), float(pos[2])))
    n = px.shape[0]
    dev = px.device
    o = Vec3(torch.full((n,), float(pos[0]), device=dev),
             torch.full((n,), float(pos[1]), device=dev),
             torch.full((n,), float(pos[2]), device=dev))
    return Rays(o=o, d=d, time=torch.zeros((n,), device=dev))


def _row_major_pixels(nx: int, row0: int, n_rows: int, device):
    """Lane -> (px, py) of rows [row0, row0 + n_rows), image-row-major."""
    px = torch.arange(nx, dtype=torch.int32, device=device).repeat(n_rows)
    py = (row0 + torch.arange(n_rows, dtype=torch.int32, device=device)
          ).repeat_interleave(nx)
    return px, py


def primary_rays(cam: Camera, row0: int = 0, n_rows: int | None = None,
                 device="cuda") -> Rays:
    """Center-of-pixel rays, time 0, in image-row-major lane order (not
    band_pixels' tile order), on ``device``; ``row0`` and ``n_rows``
    select a band of rows (all of them by default)."""
    n_rows = cam.ny if n_rows is None else n_rows
    return primary_rays_at(cam, *_row_major_pixels(cam.nx, row0, n_rows,
                                                   device))


def _f32(v) -> float:
    """A host double rounded once to float32, as JAX rounds a Python scalar
    where it meets a float32 array."""
    return float(np.float32(v))


def sample_rays_at(cam: Camera, key: rng.Key, px: torch.Tensor,
                   py: torch.Tensor, base: int, count: int) -> Rays:
    """Jittered sample rays for per-lane pixel coords, sample-major lanes.

    ``px``/``py`` are [P] int32 pixel coordinates (frame space); the output
    has P * count lanes, a pixel's ``count`` samples consecutive, for
    samples ``base .. base + count - 1``.

    Grid placement per getSampleRay (src/Camera.cpp:94-113): sample s sits
    in cell (s % g, s // g) of a g x g sub-pixel grid with uniform jitter.
    With depth of field the ray starts on the lens and gets time 0
    (src/Camera.cpp:119-139); otherwise its time is uniform in [0, 1), for
    motion blur. One ``(5, P, count)`` draw, as the JAX package makes it.
    """
    g = cam.grid
    P, S = px.shape[0], count
    dev = px.device
    pos = np.asarray(cam.pos, np.float32)
    right = np.asarray(cam.right, np.float32)
    up = np.asarray(cam.up, np.float32)
    gaze = np.asarray(cam.gaze, np.float32)
    near = np.float32(cam.near_distance)
    base3 = [float(pos[k] + gaze[k] * near) for k in range(3)]   # f32 host

    pw = (cam.right_edge - cam.left) / cam.nx       # host doubles
    ph = (cam.top - cam.bottom) / cam.ny
    sw, sh = pw / g, ph / g

    # pixel lower-bottom corners (PixelLBCorner, src/Camera.cpp:84-92)
    ub = (_f32(cam.left) + px.float() * _f32(pw))[:, None]         # [P, 1]
    vb = (_f32(cam.top) - (py + 1).float() * _f32(ph))[:, None]

    s = base + torch.arange(S, dtype=torch.int64, device=dev)
    si = (s % g).float()                                            # [S]
    sj = (s // g).float()

    chi = rng.uniform(key, (5, P, S), dev)
    ju = ub + (si[None, :] + chi[0]) * _f32(sw)                     # [P, S]
    jv = vb + (sj[None, :] + chi[1]) * _f32(sh)
    m = Vec3(*(base3[k] + ju * float(right[k]) + jv * float(up[k])
               for k in range(3)))
    posv = Vec3(float(pos[0]), float(pos[1]), float(pos[2]))
    d = vnormalize(m - posv)

    if cam.is_dof:
        ap = _f32(cam.aperture_size)
        lu = ap * (chi[2] - 0.5)
        lv = ap * (chi[3] - 0.5)
        q = Vec3(*(float(pos[k]) + lu * float(right[k]) + lv * float(up[k])
                   for k in range(3)))
        gz = Vec3(float(gaze[0]), float(gaze[1]), float(gaze[2]))
        t_fd = rdiv(_f32(cam.focus_distance), vdot(d, gz))
        d = vnormalize((posv + d * t_fd) - q)
        o = q
        time = torch.zeros((P, S), device=dev)
    else:
        o = Vec3(*(torch.full((P, S), float(pos[k]), device=dev)
                   for k in range(3)))
        time = chi[4]

    n = P * S
    return Rays(o=Vec3(o.x.reshape(n), o.y.reshape(n), o.z.reshape(n)),
                d=Vec3(d.x.reshape(n), d.y.reshape(n), d.z.reshape(n)),
                time=time.reshape(n))


def sample_rays(cam: Camera, key: rng.Key, device="cuda") -> Rays:
    """All jittered sample rays of a frame, [ny * nx * num_samples] lanes."""
    return sample_rays_range(cam, key, 0, cam.num_samples, device=device)


def sample_rays_range(cam: Camera, key: rng.Key, base: int, count: int,
                      row0: int = 0, n_rows: int | None = None,
                      device="cuda") -> Rays:
    """Jittered samples [base, base + count) of rows [row0, row0 + n_rows)
    in image-row-major lane order (see sample_rays_at); the chi draw over
    the [P, count] lanes is the JAX package's draw bit for bit."""
    n_rows = cam.ny if n_rows is None else n_rows
    return sample_rays_at(cam, key, *_row_major_pixels(cam.nx, row0, n_rows,
                                                       device), base, count)
