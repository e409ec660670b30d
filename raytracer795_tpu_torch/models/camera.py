"""Camera ray generation (lane-major Vec3 output).

Counterpart of ``raytracer795_tpu/models/camera.py``: tile-swizzled lane
order and center-of-pixel primary rays (src/Camera.cpp:63-72). Jittered
multi-sample rays wait for the RNG that matches JAX (ROADMAP queue 1
items 10 and 12).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer795_tpu_torch.ops.intersect import Rays
from raytracer795_tpu_torch.scene.types import Camera
from raytracer795_tpu_torch.utils.vec3 import Vec3, cdiv, vnormalize

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
