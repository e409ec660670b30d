"""Monte Carlo path tracer (the reference's hw7, pages/Page7.md).

Counterpart of ``raytracer795_tpu/models/path_tracer.py``. Every
pixel-sample lane carries one continuation ray and a throughput; each
bounce traces all live lanes as one wavefront, and every decision is a
lane mask. Random numbers come from the RNG that matches ``jax.random``
(``utils/rng.py``) with the JAX package's keys, so a frame equals the JAX
render of the same seed lane for lane, up to the last-ulp differences of
transcendentals.

Semantics (the JAX module's docstring has the derivations):
- emission counts when a ray hits an emissive primitive; with NEE on, only
  for camera rays and rays leaving specular vertices (pages/Page7.md:149);
- at diffuse vertices, NEE area-samples every object light (sphere lights
  with the |cof(M) n| Jacobian, mesh lights by area CDF) with an exact
  occlusion cap, and the classic lights contribute through the Whitted
  integrator's ``direct_lighting``;
- diffuse vertices continue on a uniform or cosine hemisphere sample,
  mirror and conductor on the reflection, dielectrics on reflection with
  probability Fresnel or refraction otherwise, with Beer absorption;
- lanes stop at the bounce cap, on NaN or a throughput <= 1e-6, and under
  Russian roulette from bounce 1 with survival q = clip(max tput, 0.05, 1).

Bounce ``i`` draws from keys ``fold_in(fold_in(key, i), 1|2|3|4)``, so the
loop may end as soon as no lane is live without changing any pixel.

Gradients: with autograd on, pixels are differentiable in the material
tables, light powers and radiances, vertices and texture images. The
gradient stops where the JAX package stops it: at the traversal queries
and the NEE occlusion cap; Russian roulette's survival q stays on the tape.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from raytracer795_tpu_torch.models.brdf import _mat3_rows, term_brdf
from raytracer795_tpu_torch.models.lights import ShadePoint, direct_lighting
from raytracer795_tpu_torch.models.whitted import (_conductor_fresnel,
                                                   _fresnel_dielectric,
                                                   _glossy_perturb, _refract,
                                                   n_shadow_lights)
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.ops.texture import apply_textures
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils import graphs, rng
from raytracer795_tpu_torch.utils.vec3 import (Vec3, cdiv, const_mat3_apply,
                                               sqrt,
                                               vany_nan, vcross, vdot, vnorm,
                                               vnormalize, vorthonormal_u,
                                               vreflect, vsafe_normalize,
                                               vscrub_nan, vwhere)
from raytracer795_tpu_torch.utils.vecmath import safe_pow


def _pt_brdf(wi: Vec3, wo: Vec3, normal: Vec3, mats, mat_idx) -> Vec3:
    """BRDF for path tracing: the reference's 8 models for materials that
    name one; otherwise the normalized Blinn-Phong pair
    kd/pi + ks (p+8)/(8 pi) (n.h)^p (src/Light.cpp:112-121), which
    conserves energy where the unnormalized shading formula would not."""
    mi = mat_idx.long()
    f = term_brdf(wi, wo, normal, mats, mi)
    kd = _mat3_rows(mats.diffuse, mi)
    ks = _mat3_rows(mats.specular, mi)
    pexp = mats.phong[mi]
    h = vsafe_normalize(wo + wi)    # wi == -wo on dead lanes => |h| == 0
    cos_h = torch.clamp_min(vdot(normal, h), 0.0)
    f_plain = cdiv(kd, math.pi) + ks * (cdiv(pexp + 8.0, 8.0 * math.pi)
                                        * safe_pow(cos_h, pexp))
    return vwhere(mats.brdf[mi] == T.BRDF_NONE, f_plain, f)


def _sample_hemisphere(n: Vec3, chi0, chi1, importance: bool):
    """Direction and pdf around normal ``n`` from two [N] uniforms."""
    u = vorthonormal_u(n)
    w = vcross(n, u)
    phi = chi1 * 2.0 * math.pi
    if importance:
        # cosine-weighted: pdf = cos/pi
        r = sqrt(chi0)
        z = sqrt(torch.clamp_min(1.0 - chi0, 0.0))
        d = u * (r * torch.cos(phi)) + w * (r * torch.sin(phi)) + n * z
        pdf = torch.clamp_min(cdiv(z, math.pi), 1e-8)
    else:
        # uniform: pdf = 1/(2pi)
        z = chi0
        r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        d = u * (r * torch.cos(phi)) + w * (r * torch.sin(phi)) + n * z
        pdf = torch.full(z.shape, 1.0 / (2.0 * math.pi), device=z.device)
    return vnormalize(d), pdf


def _object_light_nee(scene: T.Scene, sp: ShadePoint, key: rng.Key) -> Vec3:
    """Direct contribution of all object lights via area sampling; light
    ``idx`` (sphere lights first) draws from ``fold_in(key, 7000 + idx)``."""
    N = sp.time.shape[0]
    dev = sp.time.device
    out = Vec3.zeros((N,), dev)
    mats = scene.materials
    eps = scene.shadow_eps

    def shade_from_sample(lpos: Vec3, lnormal: Vec3, radiance, pdf_area):
        to_l = lpos - sp.point
        d2 = vdot(to_l, to_l)
        # guarded sqrt/division: dead lanes can have sample == point
        dist = sqrt(torch.where(d2 > 0, d2, 1.0))
        dist = torch.where(d2 > 0, dist, 1.0)
        wi = to_l * (1.0 / dist)
        # occlusion: any hit strictly closer than the sample point (the
        # backface-shadow fix of pages/Page7.md:143): |eps*n + t*wi| <
        # dist - 2*eps solved for the exact t_cap. Lanes without a shade
        # point get a zero direction, which retires them at kernel entry;
        # their contribution is masked below. Visibility is discrete: the
        # query and its cap carry no gradient, as the JAX package stops it
        # at c and dist.
        with torch.no_grad():
            c = vdot(sp.normal, wi)
            dlim = dist - 2.0 * eps
            rad = torch.clamp_min(eps * eps * (c * c - 1.0) + dlim * dlim,
                                  0.0)
            t_cap = -eps * c + sqrt(rad)
            rays = intersect.Rays(o=sp.point + sp.normal * eps,
                                  d=vwhere(sp.valid, wi, 0.0), time=sp.time)
            visible = ~intersect.trace_anyhit(scene, rays, t_cap)
        cos_x = torch.clamp_min(vdot(sp.normal, wi), 0.0)
        cos_l = torch.abs(vdot(lnormal, -wi))
        f = _pt_brdf(wi, sp.wo, sp.normal, mats, sp.mat)
        geom = cos_x * cos_l / torch.clamp_min(d2, 1e-12)
        scale = geom / torch.clamp_min(pdf_area, 1e-12)
        contrib = Vec3(radiance[0] * f.x, radiance[1] * f.y,
                       radiance[2] * f.z) * scale
        return vwhere(visible & sp.valid, contrib, 0.0)

    idx = 0
    for sl in scene.sphere_lights:
        chi = rng.uniform(rng.fold_in(key, 7000 + idx), (2, N), dev)
        z = 1.0 - 2.0 * chi[0]
        r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = 2.0 * math.pi * chi[1]
        n_l = Vec3(r * torch.cos(phi), z, r * torch.sin(phi))
        p_local = Vec3(sl.center[0] + sl.radius * n_l.x,
                       sl.center[1] + sl.radius * n_l.y,
                       sl.center[2] + sl.radius * n_l.z)
        if sl.has_xform:
            p_world = const_mat3_apply(sl.m, p_local) + Vec3(
                sl.m[0, 3], sl.m[1, 3], sl.m[2, 3])
            cof_n = const_mat3_apply(sl.cof, n_l)
            jac = vnorm(cof_n)
            n_world = vnormalize(cof_n)
        else:
            p_world = p_local
            jac = torch.ones((N,), device=dev)
            n_world = n_l
        area_local = 4.0 * math.pi * sl.radius * sl.radius
        pdf_area = 1.0 / (area_local * jac)
        out = out + shade_from_sample(p_world, n_world, sl.radiance, pdf_area)
        idx += 1

    for ml in scene.mesh_lights:
        chi = rng.uniform(rng.fold_in(key, 7000 + idx), (3, N), dev)
        ti = torch.clamp(torch.searchsorted(ml.cdf, chi[0]), 0,
                         ml.a.shape[0] - 1)
        # uniform barycentric (sqrt trick)
        su = sqrt(chi[1])
        b1 = 1.0 - su
        b2 = chi[2] * su
        b0 = 1.0 - b1 - b2
        p = (Vec3.from_array(ml.a[ti]) * b0 + Vec3.from_array(ml.b[ti]) * b1
             + Vec3.from_array(ml.c[ti]) * b2)
        n_l = Vec3.from_array(ml.normal[ti])
        pdf_area = (1.0 / torch.clamp_min(ml.total_area, 1e-12)).expand(N)
        out = out + shade_from_sample(p, n_l, ml.radiance, pdf_area)
        idx += 1

    return out


class _PTState(NamedTuple):
    """One bounce's lane state."""

    active: torch.Tensor            # [N]
    count_emission: torch.Tensor    # [N] the next hit may collect emission
    o: Vec3
    d: Vec3
    tput: Vec3
    sigma: Vec3                     # Beer coefficient of the segment
    radiance: Vec3
    net: Optional[torch.Tensor] = None  # [] int64 rays traced, with stats


def render_rays(scene: T.Scene, rays: intersect.Rays, bg_radiance: Vec3,
                key: rng.Key, with_stats: bool = False):
    """Path-trace a batch of camera rays to radiance [N, 3].

    Differentiable when autograd is on (the forward entry points of
    render.py turn it off): each bounce is checkpointed
    (``use_reentrant=False``), as the JAX package checkpoints its
    ``fori_loop`` body, and the loop ends once no lane is live.

    ``with_stats=True`` returns ``(radiance, net_rays)``: net_rays is a
    0-d int64 tensor on the rays' device, the rays live lanes traced (one
    extension ray a lane active at a bounce, plus one shadow ray for each
    NEE object light and each classic light per diffuse-shaded lane), the
    JAX package's count: the bounces it runs after the last lane died add
    0. The radiance is the same bits.
    """
    if graphs.active() and not torch.is_grad_enabled() \
            and rays.time.shape[0]:
        # the bounces through their captured programs (utils/graphs.py)
        state, _, _ = graphs.run_lanes(scene, rays, bg_radiance, key, _start,
                                       _bounce, _live,
                                       max(scene.max_depth, 1), with_stats,
                                       "path_tracer")
        radiance = state.radiance.to_array()
        return (radiance, state.net.clone()) if with_stats else radiance
    state, vertex_normals = _start(scene, rays, with_stats)
    ckpt = torch.is_grad_enabled()
    for i in range(max(scene.max_depth, 1)):
        if i and not bool(_live(state)):
            break       # later bounces would add nothing: keys are per bounce
        args = (scene, rays.time, bg_radiance, key, vertex_normals, state, i)
        state = (checkpoint(_bounce, *args, use_reentrant=False) if ckpt
                 else _bounce(*args))
    radiance = state.radiance.to_array()
    return (radiance, state.net) if with_stats else radiance


def _start(scene: T.Scene, rays: intersect.Rays, with_stats: bool = False):
    """The first bounce's state and the scene's vertex normals."""
    N = rays.o.x.shape[0]
    dev = rays.o.x.device
    state = _PTState(
        active=torch.ones((N,), dtype=torch.bool, device=dev),
        count_emission=torch.ones((N,), dtype=torch.bool, device=dev),
        o=rays.o, d=rays.d, tput=Vec3.ones((N,), dev),
        sigma=Vec3.zeros((N,), dev), radiance=Vec3.zeros((N,), dev),
        net=(torch.zeros((), dtype=torch.int64, device=dev) if with_stats
             else None))
    return state, intersect.compute_vertex_normals(scene)


def _live(s: _PTState) -> torch.Tensor:
    """Whether a lane continues (0-d bool)."""
    return s.active.any()


def _bounce(scene: T.Scene, time: torch.Tensor, bg: Vec3, key: rng.Key,
            vertex_normals: torch.Tensor, s: _PTState, i: int) -> _PTState:
    """Bounce ``i``: trace, emission, NEE and classic lights, continuation."""
    N = time.shape[0]
    dev = time.device
    mats = scene.materials
    max_bounces = max(scene.max_depth, 1)
    has_object_lights = bool(scene.sphere_lights or scene.mesh_lights)
    eps = scene.shadow_eps
    active, o, d, tput, sigma = s.active, s.o, s.d, s.tput, s.sigma

    k_iter = rng.fold_in(key, i)
    # dead lanes keep their last ray; a zero direction retires them at
    # kernel entry
    wrays = intersect.Rays(o=o, d=vwhere(active, d, 0.0), time=time)
    hit = intersect.trace(scene, wrays)
    hit_valid = hit.valid & active
    det = intersect.hit_details(scene, wrays, hit, vertex_normals)
    det = det._replace(valid=hit_valid)
    tex = apply_textures(scene, det)
    normal = tex.normal

    # Beer attenuation of the resolved segment
    seg_t = torch.where(hit_valid, det.t, 0.0)
    tput = tput * Vec3(torch.exp(-sigma.x * seg_t),
                       torch.exp(-sigma.y * seg_t),
                       torch.exp(-sigma.z * seg_t))

    # primary misses see the background; secondary misses add nothing
    # (the Whitted convention, src/Scene.cpp:150-153)
    radiance = s.radiance
    if i == 0:
        radiance = radiance + vwhere(active & ~hit_valid, bg, 0.0)
    # emission at the hit (double-count rule)
    radiance = radiance + vwhere(hit_valid & s.count_emission,
                                 tput * det.emission, 0.0)

    mi = det.mat.long()
    mtype = mats.mtype[mi]
    is_diffuse = hit_valid & (mtype == T.MAT_NORMAL)
    is_mirror = hit_valid & (mtype == T.MAT_MIRROR)
    is_conductor = hit_valid & (mtype == T.MAT_CONDUCTOR)
    is_dielectric = hit_valid & (mtype == T.MAT_DIELECTRIC)
    net = s.net
    if net is not None:
        # one extension ray an active lane, one shadow ray a light (NEE's
        # object lights and the classic ones) for each diffuse lane
        n_nee = (len(scene.sphere_lights) + len(scene.mesh_lights)
                 if scene.pt_nee else 0)
        net = (net + active.sum()
               + (n_nee + n_shadow_lights(scene)) * is_diffuse.sum())

    # ---- NEE and classic lights at diffuse vertices ----
    sp = ShadePoint(point=det.point, normal=normal, wo=-d, mat=det.mat,
                    dm=tex.dm, tex_color=tex.tex_color,
                    tex_norm=tex.tex_normalizer, time=time,
                    valid=is_diffuse)
    if scene.pt_nee and has_object_lights:
        nee = _object_light_nee(scene, sp, rng.fold_in(k_iter, 1))
        radiance = radiance + vscrub_nan(
            vwhere(is_diffuse, tput * nee, 0.0))
    classic = direct_lighting(scene, sp, rng.fold_in(k_iter, 2))
    radiance = radiance + vscrub_nan(
        vwhere(is_diffuse, tput * classic, 0.0))

    # ---- continuations ----
    chi = rng.uniform(rng.fold_in(k_iter, 3), (6, N), dev)

    # diffuse: hemisphere sample
    d_diff, pdf = _sample_hemisphere(normal, chi[0], chi[1],
                                     scene.pt_importance)
    f = _pt_brdf(d_diff, -d, normal, mats, det.mat)
    cos_s = torch.clamp_min(vdot(d_diff, normal), 0.0)
    w_diff = f * (cos_s / pdf)

    # specular shared math
    wr = vreflect(d, normal)
    wr = _glossy_perturb(wr, mats.roughness[mi], mats.is_rough[mi],
                         chi[4] - 0.5, chi[5] - 0.5)
    f_cond = _conductor_fresnel(mats.refraction[mi],
                                mats.absorption_index[mi], d, normal)
    # snell guarded on non-dielectric lanes (refraction index may be 0)
    nt = mats.refraction[mi]
    diel = mtype == T.MAT_DIELECTRIC
    nt_s = torch.where(diel, nt, 1.0)
    entering = vdot(d, normal) < 0
    no = vwhere(entering, normal, -normal)
    snell = torch.where(entering, 1.0 / nt_s, nt_s)
    t_dir, tir = _refract(d, no, snell, diel)
    n_t = torch.where(entering, nt_s, 1.0)
    n_i = torch.where(entering, 1.0, nt_s)
    fr = _fresnel_dielectric(n_t, n_i, d, t_dir, no)
    fr = torch.where(tir, 1.0, fr)
    absorb = _mat3_rows(mats.absorption_coef, mi)
    # stochastic branch pick: reflect with probability fr
    pick_reflect = chi[3] < fr
    refl = pick_reflect | tir
    diel_d = vwhere(refl, wr, t_dir)
    diel_o = vwhere(refl, det.point + normal * eps, det.point - no * eps)
    # Beer applies when the NEXT segment runs inside the medium
    diel_sigma_on = ((entering & ~pick_reflect)
                     | (~entering & (tir | pick_reflect)))
    diel_sigma = vwhere(diel_sigma_on, absorb, 0.0)

    new_d = vwhere(is_diffuse, d_diff, vwhere(is_dielectric, diel_d, wr))
    new_o = vwhere(is_dielectric, diel_o, det.point + normal * eps)
    mfac = _mat3_rows(mats.mirror, mi)
    w_next = vwhere(is_diffuse, w_diff,
                    vwhere(is_mirror, mfac,
                           vwhere(is_conductor, mfac * f_cond, 1.0)))
    sigma_next = vwhere(is_dielectric, diel_sigma, 0.0)
    tput = tput * vwhere(hit_valid, w_next, 1.0)

    # with NEE, diffuse-vertex BRDF samples must not re-collect emission
    count_emission = (~is_diffuse if scene.pt_nee
                      else torch.ones_like(is_diffuse))

    cont = hit_valid & (i + 1 < max_bounces)
    cont = cont & ~(vany_nan(new_d) | vany_nan(tput))
    tput_max = torch.maximum(tput.x, torch.maximum(tput.y, tput.z))
    cont = cont & (tput_max > 1e-6)

    # Russian roulette (throughput survival); q stays on the tape, as in
    # the JAX package, and is clipped as jnp.clip is (an even split of the
    # gradient where tput_max sits on a bound)
    if scene.pt_rr and i >= 1:
        q = torch.minimum(torch.maximum(tput_max, tput_max.new_full((), 0.05)),
                          tput_max.new_full((), 1.0))
        live = rng.uniform(rng.fold_in(k_iter, 4), (N,), dev) < q
        tput = vwhere(cont & live, tput * (1.0 / q), tput)
        cont = cont & live

    return _PTState(
        active=cont, count_emission=count_emission,
        o=vwhere(cont, new_o, o), d=vwhere(cont, new_d, d), tput=tput,
        sigma=vwhere(cont, sigma_next, sigma), radiance=radiance, net=net)
