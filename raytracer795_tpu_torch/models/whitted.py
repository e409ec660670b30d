"""Whitted integrator as an iterative masked-lane machine (forward only).

Counterpart of ``raytracer795_tpu/models/whitted.py`` with
``differentiable=False``. Every pixel is a lane carrying one current ray
plus a per-lane stack of deferred branch rays (stack-major [D, N]). One
iteration traces ALL current rays as a wavefront, accumulates emissions
with the running throughput, and either continues the lane with a child
ray, pops a deferred ray, or retires the lane.

Event table (depth = remaining recursion budget at the hit):
  miss, primary lane        -> emit background (src/Scene.cpp:378-381)
  miss, secondary lane      -> emit nothing    (src/Scene.cpp:150-153)
  Normal mat or depth <= 0  -> emit BasicShading; retire (src/Scene.cpp:155-157)
  Mirror                    -> emit BasicShading; continue reflect * mirrorRef
  Conductor                 -> emit BasicShading; continue reflect * mirrorRef * F
  Dielectric enter          -> emit BasicShading; continue refract * (1-F) with
                               Beer sigma; push reflect * F
  Dielectric exit, TIR      -> continue reflect with Beer sigma (no emission)
  Dielectric exit, no TIR   -> continue refract * (1-F); push reflect * F with
                               Beer sigma (no emission)

Beer attenuation multiplies the throughput by exp(-sigma * t) once the
segment's length is known, in the next iteration, as the JAX package does
(including its documented reading of src/Scene.cpp:110 for the internal
reflected branch).

Not ported yet, and raising: gradients (ROADMAP queue 1 item 17) and glossy
materials, whose jitter needs the RNG that matches JAX (items 10 and 12).
"""

from __future__ import annotations

import warnings

import torch

from raytracer795_tpu_torch.models.brdf import _mat3_rows
from raytracer795_tpu_torch.models.lights import ShadePoint, direct_lighting
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.ops.texture import apply_textures, check_untextured
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import (Vec3, vany_nan, vdot,
                                               vmasked_normalize, vreflect,
                                               vscrub_nan, vwhere)
from raytracer795_tpu_torch.utils.vecmath import safe_div


def _fresnel_dielectric(n_t, n_i, d: Vec3, t_dir: Vec3, no: Vec3):
    """Dielectric Fresnel (src/Scene.cpp:120-128), guarded denominators."""
    cos_t = -vdot(t_dir, no)
    cos_i = -vdot(d, no)
    r_par = safe_div(n_t * cos_i - n_i * cos_t, n_t * cos_i + n_i * cos_t)
    r_perp = safe_div(n_i * cos_i - n_t * cos_t, n_i * cos_i + n_t * cos_t)
    return 0.5 * (r_par * r_par + r_perp * r_perp)


def _conductor_fresnel(n_t, k_t, d: Vec3, n: Vec3):
    """Conductor Fresnel (src/Scene.cpp:135-146), guarded denominators."""
    cos_t = -vdot(d, n)
    two = 2.0 * n_t * cos_t
    cos2 = cos_t * cos_t
    nk2 = n_t * n_t + k_t * k_t
    rs = safe_div(nk2 - two + cos2, nk2 + two + cos2)
    rp = safe_div(nk2 * cos2 - two + 1.0, nk2 * cos2 + two + 1.0)
    return 0.5 * (rs + rp)


def _refract(d: Vec3, no: Vec3, snell, diel_mask):
    """Snell refraction direction + TIR mask (src/Scene.cpp:57-117)."""
    snell = torch.where(diel_mask, snell, 1.0)
    cos_i = -vdot(d, no)
    sqrt_part = 1.0 - snell * snell * (1.0 - cos_i * cos_i)
    tir = sqrt_part < 0
    root = (torch.sqrt(torch.where(sqrt_part > 0, sqrt_part, 1.0))
            * (sqrt_part > 0))
    t_raw = (d + no * cos_i) * snell - no * root
    t_dir = vmasked_normalize(diel_mask & ~tir, t_raw)
    return t_dir, tir


def _pick_row(st, spi, D):
    """Per-lane stack read: st[spi[i], i] via a D-way select."""
    got = st[0]
    for k in range(1, D):
        got = torch.where(spi == k, st[k], got)
    return got


def _pick_row3(st: Vec3, spi, D) -> Vec3:
    return Vec3(_pick_row(st.x, spi, D), _pick_row(st.y, spi, D),
                _pick_row(st.z, spi, D))


def _put_row(st, sp, mask, val, D):
    """Per-lane stack write at slot sp where ``mask``."""
    return torch.stack([torch.where((sp == k) & mask, val, st[k])
                        for k in range(D)], dim=0)


def _put_row3(st: Vec3, sp, mask, val: Vec3, D) -> Vec3:
    return Vec3(_put_row(st.x, sp, mask, val.x, D),
                _put_row(st.y, sp, mask, val.y, D),
                _put_row(st.z, sp, mask, val.z, D))


def iteration_bound(scene: T.Scene) -> int:
    """Worst-case iterations: a depth-D binary split tree when dielectrics
    can split a lane (capped at 1024), a chain otherwise."""
    if scene.any_dielectric:
        return min(2 ** (scene.max_depth + 1), 1024)
    return scene.max_depth + 1


def render_rays(scene: T.Scene, rays: intersect.Rays, bg_radiance: Vec3,
                differentiable: bool = False) -> torch.Tensor:
    """Shade a batch of camera rays to radiance [N, 3].

    The loop ends when every lane is idle, or at ``iteration_bound``.
    """
    if differentiable:
        raise NotImplementedError(
            "gradients are not ported yet: ROADMAP queue 1 item 17")
    if scene.any_rough:
        raise NotImplementedError(
            "glossy materials jitter with the RNG that matches JAX: ROADMAP "
            "queue 1 items 10 and 12")
    check_untextured(scene)
    with torch.no_grad():
        return _render_machine(scene, rays, bg_radiance).to_array()


def _render_machine(scene: T.Scene, rays: intersect.Rays,
                    bg: Vec3) -> Vec3:
    N = rays.o.x.shape[0]
    dev = rays.o.x.device
    D = max(scene.max_depth, 1)
    mats = scene.materials
    vertex_normals = intersect.compute_vertex_normals(scene)
    has_diel = scene.any_dielectric
    max_iters = iteration_bound(scene)

    active = torch.ones((N,), dtype=torch.bool, device=dev)
    is_primary = torch.ones((N,), dtype=torch.bool, device=dev)
    o, d, time = rays.o, rays.d, rays.time
    tput = Vec3.ones((N,), dev)
    depth = torch.full((N,), scene.max_depth, dtype=torch.int32, device=dev)
    sigma = Vec3.zeros((N,), dev)
    radiance = Vec3.zeros((N,), dev)
    sp = torch.zeros((N,), dtype=torch.int32, device=dev)
    st_o, st_d = Vec3.zeros((D, N), dev), Vec3.zeros((D, N), dev)
    st_tput, st_sigma = Vec3.zeros((D, N), dev), Vec3.zeros((D, N), dev)
    st_depth = torch.zeros((D, N), dtype=torch.int32, device=dev)

    it = 0
    while it < max_iters and bool(torch.any(active | (sp > 0))):
        # ---- pop deferred rays into idle lanes ----
        if has_diel:
            popping = (~active) & (sp > 0)
            spi = torch.clamp_min(sp - 1, 0)
            o = vwhere(popping, _pick_row3(st_o, spi, D), o)
            d = vwhere(popping, _pick_row3(st_d, spi, D), d)
            tput = vwhere(popping, _pick_row3(st_tput, spi, D), tput)
            depth = torch.where(popping, _pick_row(st_depth, spi, D), depth)
            sigma = vwhere(popping, _pick_row3(st_sigma, spi, D), sigma)
            sp = torch.where(popping, spi, sp)
            active = active | popping

        # ---- wavefront trace ----
        # idle lanes get a zero direction: the kernels retire them at entry
        d_t = vwhere(active, d, 0.0)
        wrays = intersect.Rays(o=o, d=d_t, time=time)
        hit = intersect.trace(scene, wrays)
        hit_valid = hit.valid & active
        det = intersect.hit_details(scene, wrays, hit, vertex_normals)
        det = det._replace(valid=hit_valid)
        tex = apply_textures(scene, det)
        normal = tex.normal

        # Beer attenuation of the segment just resolved
        if has_diel:
            seg_t = torch.where(hit_valid, det.t, 0.0)
            tput = tput * Vec3(torch.exp(-sigma.x * seg_t),
                               torch.exp(-sigma.y * seg_t),
                               torch.exp(-sigma.z * seg_t))

        # ---- emissions ----
        mat_idx = det.mat
        mi = mat_idx.long()
        mtype = mats.mtype[mi]
        miss_primary = active & ~hit_valid & is_primary
        radiance = radiance + vwhere(miss_primary, bg, 0.0)
        replace_all = hit_valid & is_primary & (tex.dm == T.DECAL_REPLACE_ALL)
        radiance = radiance + vwhere(replace_all, tput * tex.tex_color, 0.0)

        shading_lane = hit_valid & ~replace_all
        as_normal = shading_lane & ((mtype == T.MAT_NORMAL) | (depth <= 0))
        as_mirror = shading_lane & ~as_normal & (mtype == T.MAT_MIRROR)
        as_conductor = shading_lane & ~as_normal & (mtype == T.MAT_CONDUCTOR)
        as_dielectric = (shading_lane & ~as_normal
                         & (mtype == T.MAT_DIELECTRIC))
        entering = vdot(d, normal) < 0
        emits = (as_normal | as_mirror | as_conductor
                 | (as_dielectric & entering))

        sp_point = ShadePoint(
            point=det.point, normal=normal, wo=-d, mat=mat_idx,
            dm=tex.dm, tex_color=tex.tex_color, tex_norm=tex.tex_normalizer,
            time=time, valid=emits)
        basic = direct_lighting(scene, sp_point)
        radiance = radiance + vscrub_nan(vwhere(emits, tput * basic, 0.0))

        # ---- continuation rays ----
        eps = scene.shadow_eps
        wr = vreflect(d, normal)
        refl_o = det.point + normal * eps      # src/Scene.cpp:50 (always +n)
        mfac = _mat3_rows(mats.mirror, mi)
        if scene.any_conductor:
            f_cond = _conductor_fresnel(mats.refraction[mi],
                                        mats.absorption_index[mi], d, normal)
            w_mirror = vwhere(as_conductor, mfac * f_cond, mfac)
        else:
            w_mirror = mfac

        if has_diel:
            nt = mats.refraction[mi]
            diel = mtype == T.MAT_DIELECTRIC
            nt_s = torch.where(diel, nt, 1.0)
            no = vwhere(entering, normal, -normal)
            snell = torch.where(entering, 1.0 / nt_s, nt_s)
            t_dir, tir = _refract(d, no, snell, diel)
            refr_o = det.point - no * eps
            n_t = torch.where(entering, nt_s, 1.0)
            n_i = torch.where(entering, 1.0, nt_s)
            fr = _fresnel_dielectric(n_t, n_i, d, t_dir, no)
            fr = torch.where(tir, 1.0, fr)
            absorb = _mat3_rows(mats.absorption_coef, mi)

            cont_reflect = (as_mirror | as_conductor
                            | (as_dielectric & ~entering & tir))
            cont_refract = as_dielectric & (entering | (~entering & ~tir))
            new_o = vwhere(cont_refract, refr_o, refl_o)
            new_d = vwhere(cont_refract, t_dir, wr)
            w_next = vwhere(cont_refract, Vec3(1.0 - fr, 1.0 - fr, 1.0 - fr),
                            vwhere(as_dielectric & tir, 1.0, w_mirror))
            sigma_next = vwhere(as_dielectric & entering, absorb,
                                vwhere(as_dielectric & ~entering & tir,
                                       absorb, 0.0))
        else:
            cont_reflect = as_mirror | as_conductor
            cont_refract = torch.zeros_like(cont_reflect)
            new_o, new_d, w_next, sigma_next = refl_o, wr, w_mirror, sigma

        # NaN continuations retire (NanCheck, src/Scene.cpp:221-228)
        bad = vany_nan(new_d) | vany_nan(new_o) | vany_nan(tput)
        continues = (cont_reflect | cont_refract) & ~bad

        if has_diel:
            # ---- dielectric split: push the reflected branch ----
            pushes = as_dielectric & ~tir & ~bad
            put = pushes & (sp < D)
            st_o = _put_row3(st_o, sp, put, refl_o, D)
            st_d = _put_row3(st_d, sp, put, wr, D)
            st_tput = _put_row3(st_tput, sp, put, tput * fr, D)
            st_depth = _put_row(st_depth, sp, put, depth - 1, D)
            st_sigma = _put_row3(st_sigma, sp, put,
                                 vwhere(~entering, absorb, 0.0), D)
            sp = torch.where(put, sp + 1, sp)

        tput = tput * vwhere(continues, w_next, 1.0)
        active = continues
        is_primary = torch.zeros_like(continues)
        o = vwhere(continues, new_o, o)
        d = vwhere(continues, new_d, d)
        depth = torch.where(continues, depth - 1, depth)
        sigma = vwhere(continues, sigma_next, sigma)
        it += 1

    if it == max_iters and bool(torch.any(active | (sp > 0))):
        warnings.warn(f"Whitted lanes still live at the {max_iters}-iteration "
                      "bound; their remaining ray trees are dropped")
    return radiance
