"""Texture sampling and decal application (lane-major Vec3 layout).

Counterpart of ``raytracer795_tpu/ops/texture.py``.

Sampling contract (src/Texture.cpp:41-131): wrap uv by u - floor(u), scale
by width/height, clamp pixel fetches to the image, nearest = int
truncation, bilinear = 4-tap with fractional weights. Images hold raw
source values (bytes 0..255 for LDR, radiance floats for EXR). Pixel
fetches gather per color plane from flattened [H*W] planes.

Decal application (src/Shape.cpp:400-616): per hit, the object's (up to
two) textures apply in order; replace_kd/blend_kd/replace_all set the
hit's diffuse-replacement color and normalizer, replace_normal/bump_normal
rewrite the shading normal through the TBN frame or the derivative math,
and the Perlin variants use the noise field at the local hit point.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracer795_tpu_torch.ops import perlin as perlin_ops
from raytracer795_tpu_torch.ops.intersect import HitDetails
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import (Vec3, cdiv, rdiv, vcross,
                                               vdot, vmasked_normalize,
                                               vwhere)


class TexturedHit(NamedTuple):
    dm: torch.Tensor             # [N] int32 decal mode (DECAL_*)
    tex_color: Vec3
    tex_normalizer: torch.Tensor  # [N]
    normal: Vec3                 # world shading normal


def _fetcher(tex: T.Texture):
    """fetch(i, j) -> Vec3 of pixels (i, j), each clamped to the image."""
    img = tex.image
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, 3)
    pr, pg, pb = flat[:, 0], flat[:, 1], flat[:, 2]

    def fetch(ii, jj):
        idx = (torch.clamp(jj, 0, h - 1) * w
               + torch.clamp(ii, 0, w - 1)).long()
        return Vec3(pr[idx], pg[idx], pb[idx])
    return fetch, h, w


def sample_image(tex: T.Texture, u: torch.Tensor, v: torch.Tensor) -> Vec3:
    """GetColorAtCoordinates (src/Texture.cpp:111-131). [N] uv -> Vec3."""
    fetch, h, w = _fetcher(tex)
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    i = u * w
    j = v * h
    if tex.interp == T.INTERP_NN:
        return fetch(i.to(torch.int32), j.to(torch.int32))
    i0 = torch.floor(i).to(torch.int32)
    j0 = torch.floor(j).to(torch.int32)
    a = i - i0
    b = j - j0
    return (fetch(i0, j0) * ((1 - a) * (1 - b))
            + fetch(i0, j0 + 1) * ((1 - a) * b)
            + fetch(i0 + 1, j0) * (a * (1 - b))
            + fetch(i0 + 1, j0 + 1) * (a * b))


def sample_gradient(tex: T.Texture, u: torch.Tensor, v: torch.Tensor):
    """GetChangeAtCoordinates (src/Texture.cpp:76-109): (du, dv) [N] each."""
    fetch, h, w = _fetcher(tex)
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    i = torch.clamp((u * w).to(torch.int32), 0, w - 2)
    j = torch.clamp((v * h).to(torch.int32), 0, h - 2)

    def mean3(c: Vec3):
        return cdiv(c.x + c.y + c.z, 3.0)

    c00 = fetch(i, j)
    du = mean3(fetch(i + 1, j)) - mean3(c00)
    dv = mean3(fetch(i, j + 1) - c00)
    return du, dv


def _sphere_dp(det: HitDetails):
    """Sphere dpdu/dpdv at the hit (src/Shape.cpp:430-433)."""
    lc = det.local_point - det.local_center
    pi = math.pi
    sel = det.valid & det.is_sphere
    cos_t = torch.clamp(lc.y / torch.where(det.radius > 0, det.radius, 1.0),
                        -1.0, 1.0)
    theta = torch.arccos(torch.where(sel, cos_t, 0.0))
    phi = torch.atan2(lc.z, torch.where(sel, lc.x, 1.0))
    dpdu = Vec3(lc.z * 2 * pi, torch.zeros_like(phi), lc.x * (-2) * pi)
    dpdv = Vec3(lc.y * torch.cos(phi) * pi,
                (-1.0) * det.radius * torch.sin(theta) * pi,
                lc.y * torch.sin(phi) * pi)
    return dpdu, dpdv


def _tri_tb(det: HitDetails):
    """Triangle tangent/bitangent from the edge/UV system
    (src/Shape.cpp:535-543).

    Solves A @ TB = E with A = [[du1, dv1], [du2, dv2]], E = [e1; e2].
    """
    du1 = det.uv1u - det.uv0u
    dv1 = det.uv1v - det.uv0v
    du2 = det.uv2u - det.uv0u
    dv2 = det.uv2v - det.uv0v
    det_a = du1 * dv2 - dv1 * du2
    ok = det_a != 0
    inv = torch.where(ok, rdiv(1.0, torch.where(ok, det_a, 1.0)), 0.0)
    t_vec = (det.tri_e1 * dv2 - det.tri_e2 * dv1) * inv
    b_vec = (det.tri_e1 * (-du2) + det.tri_e2 * du1) * inv
    return t_vec, b_vec


def apply_textures(scene: T.Scene, det: HitDetails) -> TexturedHit:
    """Run the hit's texture list, producing decal state and final normal.

    Statically loops over the scene's textures; each lane applies a texture
    iff its tex0/tex1 slot references it (slot order: tex0 then tex1),
    mirroring the per-object texture loop of src/Shape.cpp:400-616. The
    normal-map math runs on the LOCAL-space normal, as the reference
    textures inside the per-object BVH step; the world transform by
    (M^-1)^T is applied once at the end (src/Helper.cpp:75-78).
    """
    N = det.normal.x.shape[0]
    dev = det.normal.x.device
    dm = torch.full((N,), T.DECAL_NONE, dtype=torch.int32, device=dev)
    tex_color = Vec3.zeros((N,), dev)
    tex_norm = torch.ones((N,), device=dev)
    cur_n = det.normal

    for slot_ids in (det.tex0, det.tex1):
        for ti, tex in enumerate(scene.textures):
            decal, _, ttype, nc = scene.texture_statics[ti]
            if decal in (T.DECAL_NONE, T.DECAL_REPLACE_BACKGROUND):
                continue
            use = det.valid & (slot_ids == ti)
            if ttype == T.TEX_IMAGE:
                if decal in (T.DECAL_REPLACE_KD, T.DECAL_BLEND_KD,
                             T.DECAL_REPLACE_ALL):
                    color = sample_image(tex, det.u, det.v)
                    dm = torch.where(use, decal, dm)
                    tex_color = vwhere(use, color, tex_color)
                    tex_norm = torch.where(use, tex.normalizer, tex_norm)
                elif decal == T.DECAL_REPLACE_NORMAL:
                    rn = vmasked_normalize(
                        use, sample_image(tex, det.u, det.v) / 255.0 - 0.5)
                    dpdu_s, dpdv_s = _sphere_dp(det)
                    t_vec, b_vec = _tri_tb(det)
                    sph = use & det.is_sphere
                    tt = vwhere(det.is_sphere,
                                vmasked_normalize(sph, dpdu_s), t_vec)
                    bb = vwhere(det.is_sphere,
                                vmasked_normalize(sph, dpdv_s), b_vec)
                    # TBN columns: T, B, N (src/Shape.cpp:438-443,548-553);
                    # sphere T/B are normalized, triangle T/B are NOT.
                    newn = tt * rn.x + bb * rn.y + cur_n * rn.z
                    cur_n = vwhere(use, newn, cur_n)
                elif decal == T.DECAL_BUMP_NORMAL:
                    du, dv = sample_gradient(tex, det.u, det.v)
                    du = du * tex.bump_factor
                    dv = dv * tex.bump_factor
                    dpdu_s, dpdv_s = _sphere_dp(det)
                    t_vec, b_vec = _tri_tb(det)
                    tt = vwhere(det.is_sphere, dpdu_s, t_vec)
                    bb = vwhere(det.is_sphere, dpdv_s, b_vec)
                    dpu = tt + cur_n * du
                    dpv = bb + cur_n * dv
                    newn = vmasked_normalize(use, vcross(dpv, dpu))
                    # orient along the old normal (src/Shape.cpp:464-471)
                    flip = vdot(cur_n, newn) < 0
                    newn = vwhere(flip, -newn, newn)
                    cur_n = vwhere(use, newn, cur_n)
            else:  # Perlin
                if decal == T.DECAL_REPLACE_KD:
                    val = perlin_ops.perlin(det.local_point, tex.noise_scale,
                                            nc)
                    dm = torch.where(use, T.DECAL_REPLACE_KD, dm)
                    tex_color = vwhere(use, Vec3(val, val, val), tex_color)
                    tex_norm = torch.where(use, 1.0, tex_norm)
                elif decal == T.DECAL_BUMP_NORMAL:
                    g = perlin_ops.perlin_gradient(det.local_point,
                                                   tex.noise_scale, nc)
                    g_par = cur_n * vdot(g, cur_n)
                    newn = cur_n - (g - g_par) * tex.bump_factor
                    flip = vdot(cur_n, newn) < 0
                    newn = vwhere(flip, -newn, newn)
                    newn = vmasked_normalize(use, newn)
                    cur_n = vwhere(use, newn, cur_n)

    # world transform of the (possibly rewritten) local normal, once per
    # hit; miss lanes get a unit vector (masked normalize)
    world_n = vmasked_normalize(det.valid, det.minv_t.apply(cur_n))
    return TexturedHit(dm=dm, tex_color=tex_color, tex_normalizer=tex_norm,
                       normal=world_n)
