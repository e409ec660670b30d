"""Direct lighting: ambient plus point, directional and spot lights with
shadows.

Counterpart of ``raytracer795_tpu/models/lights.py``. Contract:
Light::BasicShading per type (src/Light.cpp:238-250, 309-321, 409-436) and
Scene::BasicShading/ambient (src/Scene.cpp:22-30, 243-267). Each light
traces one batched occlusion query (``intersect.trace_anyhit``), which on
a BVH group is the any-hit kernel. Area lights sample with the RNG that
matches JAX and are not ported yet (ROADMAP queue 1 items 10 and 12).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from raytracer795_tpu_torch.models.brdf import (_mat3_rows, gather_brdf_rec,
                                                term_brdf_rec)
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import (Vec3, vdot, vnorm,
                                               vsafe_normalize, vwhere)
from raytracer795_tpu_torch.utils.vecmath import safe_pow


class ShadePoint(NamedTuple):
    """Per-lane inputs to direct lighting."""
    point: Vec3             # world hit point
    normal: Vec3            # world shading normal
    wo: Vec3                # unit vector toward the viewer
    mat: torch.Tensor       # [N] int32
    dm: torch.Tensor        # [N] int32 decal mode
    tex_color: Vec3
    tex_norm: torch.Tensor  # [N]
    time: torch.Tensor      # [N]
    valid: torch.Tensor     # [N] bool


class _ShadeRec(NamedTuple):
    """Per-lane material rows gathered once per direct_lighting call."""

    kd_eff: Vec3        # diffuse after decal modes (src/Light.cpp:206-223)
    ks: Vec3
    p: torch.Tensor
    brdf: Any           # BrdfRec, or None when no material has a BRDF


def _shade_rec(scene: T.Scene, sp: ShadePoint) -> _ShadeRec:
    mats = scene.materials
    kd = _mat3_rows(mats.diffuse, sp.mat)
    tex = sp.tex_color * (1.0 / sp.tex_norm)
    kd_eff = vwhere(sp.dm == T.DECAL_REPLACE_KD, tex, kd)
    kd_eff = vwhere(sp.dm == T.DECAL_BLEND_KD, (kd + tex) * 0.5, kd_eff)
    brdf = gather_brdf_rec(mats, sp.mat) if scene.any_brdf else None
    return _ShadeRec(kd_eff=kd_eff, ks=_mat3_rows(mats.specular, sp.mat),
                     p=mats.phong[sp.mat.long()], brdf=brdf)


def _lit_color(sp: ShadePoint, rec: _ShadeRec, wi: Vec3,
               contribution: Vec3) -> Vec3:
    """BRDF vs Blinn-Phong diffuse+specular per lane (src/Light.cpp:243-249)."""
    cos_i = torch.clamp_min(vdot(sp.normal, wi), 0.0)
    diffuse = contribution * rec.kd_eff * cos_i
    h = vsafe_normalize(sp.wo + wi)
    cos_h = torch.clamp_min(vdot(sp.normal, h), 0.0)
    specular = contribution * rec.ks * safe_pow(cos_h, rec.p)
    via_ds = diffuse + specular
    if rec.brdf is None:
        return via_ds
    f = term_brdf_rec(wi, sp.wo, sp.normal, rec.brdf)
    via_brdf = contribution * f * cos_i
    return vwhere(rec.brdf.btype != T.BRDF_NONE, via_brdf, via_ds)


def shadow_rays(scene: T.Scene, sp: ShadePoint, direction: Vec3,
                d_light=None):
    """Shadow rays and their caps: (Rays, t_cap).

    The origin is offset along the normal (src/Light.cpp:192). The
    reference compares the occluder's distance FROM THE HIT POINT with the
    light distance (src/Light.cpp:197-200): with o = p + eps*n that is
    t < t_cap for t_cap = -eps*c + sqrt(eps^2*(c^2 - 1) + d_light^2),
    c = n.d, solved exactly. ``d_light=None`` (directional): any hit
    occludes. Lanes without a shade point get a zero direction, which
    retires them at kernel entry.
    """
    eps = scene.shadow_eps
    with torch.no_grad():
        o = sp.point + sp.normal * eps
        direction = vwhere(sp.valid, direction, 0.0)
        if d_light is None:
            t_cap = 3.0e38
        else:
            c = vdot(sp.normal, direction)
            d2 = d_light * d_light
            rad = torch.clamp_min(eps * eps * (c * c - 1.0) + d2, 0.0)
            t_cap = -eps * c + torch.sqrt(rad)
        return intersect.Rays(o=o, d=direction, time=sp.time), t_cap


def _occluded(scene: T.Scene, sp: ShadePoint, direction: Vec3, d_light=None):
    """Shadow test via the any-hit query (see ``shadow_rays``)."""
    return intersect.trace_anyhit(
        scene, *shadow_rays(scene, sp, direction, d_light))


def direct_lighting(scene: T.Scene, sp: ShadePoint) -> Vec3:
    """Ambient + sum over all lights (Scene::BasicShading)."""
    lights = scene.lights
    if lights.area_pos.shape[0]:
        raise NotImplementedError(
            "area lights sample with the RNG that matches JAX: ROADMAP "
            "queue 1 items 10 and 12")
    mats = scene.materials
    amb = lights.ambient
    mamb = _mat3_rows(mats.ambient, sp.mat)
    out = Vec3(amb[0] * mamb.x, amb[1] * mamb.y, amb[2] * mamb.z)
    rec = _shade_rec(scene, sp)
    N = sp.time.shape[0]

    # ---- point lights (src/Light.cpp:166-250) ----
    for i in range(lights.point_pos.shape[0]):
        pos = lights.point_pos[i]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        wi = topoint * (1.0 / d_light)
        shadowed = _occluded(scene, sp, wi, d_light)
        inten = lights.point_intensity[i]
        inv_d2 = 1.0 / (d_light * d_light)
        contribution = Vec3(inten[0] * inv_d2, inten[1] * inv_d2,
                            inten[2] * inv_d2)
        lit = _lit_color(sp, rec, wi, contribution)
        out = out + vwhere(sp.valid & ~shadowed, lit, 0.0)

    # ---- directional lights (src/Light.cpp:256-321) ----
    for i in range(lights.dir_dir.shape[0]):
        dd = lights.dir_dir[i]
        ones = torch.ones((N,), device=sp.time.device)
        wi = Vec3(-dd[0] * ones, -dd[1] * ones, -dd[2] * ones)
        occ = _occluded(scene, sp, wi, None)
        rad = lights.dir_radiance[i]
        contribution = Vec3(rad[0] * ones, rad[1] * ones, rad[2] * ones)
        lit = _lit_color(sp, rec, wi, contribution)
        out = out + vwhere(sp.valid & ~occ, lit, 0.0)

    # ---- spot lights (src/Light.cpp:327-436) ----
    for i in range(lights.spot_pos.shape[0]):
        pos = lights.spot_pos[i]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        wi = topoint * (1.0 / d_light)
        shadowed = _occluded(scene, sp, wi, d_light)
        inten = lights.spot_intensity[i]
        inv_d2 = 1.0 / (d_light * d_light)
        contribution = Vec3(inten[0] * inv_d2, inten[1] * inv_d2,
                            inten[2] * inv_d2)
        lit = _lit_color(sp, rec, wi, contribution)
        # falloff (src/Light.cpp:338-348, 409-436)
        sd = lights.spot_dir[i]
        cos_a = torch.clamp(-(wi.x * sd[0] + wi.y * sd[1] + wi.z * sd[2]),
                            -1.0, 1.0)
        angle = torch.arccos(torch.where(sp.valid, cos_a, 0.0))
        cf = torch.cos(lights.spot_falloff[i])
        cc = torch.cos(lights.spot_coverage[i])
        f = (torch.cos(angle) - cc) / (cf - cc)
        f2 = f * f
        factor = f2 * f2                    # x ** 4 as jax's integer_pow
        scale = torch.where(angle < lights.spot_falloff[i], 1.0,
                            torch.where(angle < lights.spot_coverage[i],
                                        factor, 0.0))
        out = out + vwhere(sp.valid & ~shadowed, lit * scale, 0.0)

    return out
