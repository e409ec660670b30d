"""Whitted integrator as an iterative masked-lane machine.

Counterpart of ``raytracer795_tpu/models/whitted.py``. Every pixel is a lane
carrying one current ray plus a per-lane stack of deferred branch rays
(stack-major [D, N]). One
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

Glossy materials jitter the mirror direction (src/Scene.cpp:41-47) with
the RNG that matches ``jax.random``: iteration ``it`` draws from
``fold_in(fold_in(key, it), 7)`` and passes ``fold_in(key, it)`` to direct
lighting.

Gradients (``differentiable=True``): pixels are differentiable in the
material tables, light powers, vertices and texture images. As in the JAX
package, the traversal queries carry no gradient (which primitive a ray
hits is piecewise constant) and ``intersect.hit_details`` recomputes the
winner's geometry on the tape; every guard that keeps masked lanes finite
in reverse mode sits where the JAX package has it. Each iteration's body
is checkpointed, so the backward pass recomputes the iteration, queries
included, instead of keeping its wavefront.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from raytracer795_tpu_torch.models.brdf import _mat3_rows
from raytracer795_tpu_torch.models.lights import ShadePoint, direct_lighting
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.ops.texture import apply_textures
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils import graphs, rng
from raytracer795_tpu_torch.utils.vec3 import (Vec3, sqrt, vany_nan, vcross,
                                               vdot, vmasked_normalize,
                                               vorthonormal_u, vreflect,
                                               vsafe_normalize, vscrub_nan,
                                               vwhere)
from raytracer795_tpu_torch.utils.vecmath import safe_div


def _glossy_perturb(wr: Vec3, roughness, is_rough, chi0, chi1) -> Vec3:
    """Rough-mirror jitter (src/Scene.cpp:41-47)."""
    u = vorthonormal_u(wr)
    v = vcross(wr, u)
    wr2 = vsafe_normalize(wr + (u * chi0 + v * chi1) * roughness)
    return vwhere(is_rough, wr2, wr)


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
    root = (sqrt(torch.where(sqrt_part > 0, sqrt_part, 1.0))
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


class _State(NamedTuple):
    """One iteration's lane state (the per-lane stacks are [D, N])."""

    active: torch.Tensor        # [N] lane has a current ray
    is_primary: torch.Tensor    # [N] current ray is the camera ray
    o: Vec3
    d: Vec3
    tput: Vec3
    depth: torch.Tensor         # [N] remaining recursion budget
    sigma: Vec3                 # Beer coefficient of the current segment
    radiance: Vec3
    sp: torch.Tensor            # [N] stack depth
    st_o: Vec3
    st_d: Vec3
    st_tput: Vec3
    st_depth: torch.Tensor
    st_sigma: Vec3
    net: Optional[torch.Tensor] = None  # [] int64 rays traced, with stats


def n_shadow_lights(scene: T.Scene) -> int:
    """Lights that trace one occlusion ray per shaded lane: point,
    directional, spot and area lights, and the environment light."""
    return int(scene.lights.point_pos.shape[0]
               + scene.lights.dir_dir.shape[0]
               + scene.lights.spot_pos.shape[0]
               + scene.lights.area_pos.shape[0]) \
        + (1 if scene.env_texture >= 0 else 0)


def iteration_bound(scene: T.Scene) -> int:
    """Worst-case iterations: a depth-D binary split tree when dielectrics
    can split a lane (capped at 1024), a chain otherwise."""
    if scene.any_dielectric:
        return min(2 ** (scene.max_depth + 1), 1024)
    return scene.max_depth + 1


def render_rays(scene: T.Scene, rays: intersect.Rays, bg_radiance: Vec3,
                key: rng.Key, differentiable: bool = False,
                max_iters: int | None = None, with_stats: bool = False):
    """Shade a batch of camera rays to radiance [N, 3].

    ``with_stats=True`` returns ``(radiance, net_rays)``: net_rays is a
    0-d int64 tensor on the rays' device, the rays live lanes traced (one
    extension ray a lane active in an iteration, plus one shadow ray per
    shadow light for each lane shaded), the JAX package's count. The
    radiance is the same bits; without stats no reduction is launched.

    ``differentiable=False`` (the port's default; the JAX package's is
    True) renders without autograd, until every lane is idle or at
    ``iteration_bound``, and ignores ``max_iters``.

    ``differentiable=True`` builds the autograd graph, each iteration's body
    checkpointed (``use_reentrant=False``), as the JAX package's
    ``fori_loop`` over ``jax.checkpoint``. The trip count is
    ``min(max_iters, until every lane is idle)``: the JAX package runs the
    iterations after that as no-ops. ``max_iters=None`` is
    ``iteration_bound``, exponential in the depth on dielectric scenes, so
    callers pass ``forward_iteration_count`` plus a margin. Its frame equals
    the ``differentiable=False`` frame bit for bit when ``max_iters`` is at
    least the measured count.
    """
    if not differentiable:
        with torch.no_grad():
            if graphs.active() and rays.time.shape[0]:
                radiance, net = _render_graphed(scene, rays, bg_radiance, key,
                                                with_stats)
            else:
                radiance, _, net = _render_machine(
                    scene, rays, bg_radiance, key, iteration_bound(scene),
                    with_stats)
    else:
        trips = iteration_bound(scene) if max_iters is None else max_iters
        radiance, _, net = _render_machine(scene, rays, bg_radiance, key,
                                           trips, with_stats)
    return (radiance, net) if with_stats else radiance


def _render_graphed(scene: T.Scene, rays: intersect.Rays, bg: Vec3,
                    key: rng.Key, with_stats: bool):
    """The lane machine through its captured programs (utils/graphs.py):
    the same iterations, each a replay, the same early exit."""
    bound = iteration_bound(scene)
    state, it, still = graphs.run_lanes(scene, rays, bg, key, _start,
                                        _iteration, _live, bound,
                                        with_stats, "whitted")
    if it == bound and still:
        _warn_dropped(bound)
    return (state.radiance.to_array(),
            state.net.clone() if with_stats else None)


def _warn_dropped(max_iters: int):
    warnings.warn(f"Whitted lanes still live at the {max_iters}-iteration "
                  "bound; their remaining ray trees are dropped")


def forward_iteration_count(scene: T.Scene, rays: intersect.Rays,
                            bg_radiance: Vec3, key: rng.Key) -> int:
    """Iterations the forward lane machine takes: the deepest lane's
    ray-tree size. The tree's shape is piecewise constant in the scene's
    continuous parameters, so this plus a margin is a trip count for
    ``render_rays(..., differentiable=True, max_iters=...)``."""
    with torch.no_grad():
        return _render_machine(scene, rays, bg_radiance, key,
                               iteration_bound(scene))[1]


def _start(scene: T.Scene, rays: intersect.Rays, with_stats: bool = False):
    """The lane machine's first state and the scene's vertex normals."""
    N = rays.o.x.shape[0]
    dev = rays.o.x.device
    D = max(scene.max_depth, 1)
    state = _State(
        active=torch.ones((N,), dtype=torch.bool, device=dev),
        is_primary=torch.ones((N,), dtype=torch.bool, device=dev),
        o=rays.o, d=rays.d, tput=Vec3.ones((N,), dev),
        depth=torch.full((N,), scene.max_depth, dtype=torch.int32,
                         device=dev),
        sigma=Vec3.zeros((N,), dev), radiance=Vec3.zeros((N,), dev),
        sp=torch.zeros((N,), dtype=torch.int32, device=dev),
        st_o=Vec3.zeros((D, N), dev), st_d=Vec3.zeros((D, N), dev),
        st_tput=Vec3.zeros((D, N), dev),
        st_depth=torch.zeros((D, N), dtype=torch.int32, device=dev),
        st_sigma=Vec3.zeros((D, N), dev),
        net=(torch.zeros((), dtype=torch.int64, device=dev) if with_stats
             else None))
    return state, intersect.compute_vertex_normals(scene)


def _live(s: _State) -> torch.Tensor:
    """Whether a lane has a current or a deferred ray (0-d bool)."""
    return torch.any(s.active | (s.sp > 0))


def _render_machine(scene: T.Scene, rays: intersect.Rays, bg: Vec3,
                    key: rng.Key, max_iters: int, with_stats: bool = False):
    """Runs the lane machine for at most ``max_iters`` iterations, each
    checkpointed when autograd is on; returns (radiance [N, 3],
    iterations, net rays or None without stats)."""
    state, vertex_normals = _start(scene, rays, with_stats)
    ckpt = torch.is_grad_enabled()
    it = 0
    while it < max_iters and bool(_live(state)):
        args = (scene, rays.time, bg, key, vertex_normals, state, it)
        state = (checkpoint(_iteration, *args, use_reentrant=False) if ckpt
                 else _iteration(*args))
        it += 1

    if it == max_iters and bool(_live(state)):
        _warn_dropped(max_iters)
    return state.radiance.to_array(), it, state.net


def _iteration(scene: T.Scene, time: torch.Tensor, bg: Vec3, key: rng.Key,
               vertex_normals: torch.Tensor, s: _State, it: int) -> _State:
    """One iteration of the lane machine: pop, trace, shade, continue."""
    N = time.shape[0]
    dev = time.device
    D = max(scene.max_depth, 1)
    mats = scene.materials
    has_diel = scene.any_dielectric
    o, d, tput, depth, sigma = s.o, s.d, s.tput, s.depth, s.sigma
    sp, active = s.sp, s.active
    st_o, st_d, st_tput, st_depth, st_sigma = (
        s.st_o, s.st_d, s.st_tput, s.st_depth, s.st_sigma)

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
    # idle lanes get a zero direction: the kernels retire them at entry,
    # and every quantity stays finite for reverse mode
    d_t = vwhere(active, d, 0.0)
    wrays = intersect.Rays(o=o, d=d_t, time=time)
    hit = intersect.trace(scene, wrays)
    hit_valid = hit.valid & active
    det = intersect.hit_details(scene, wrays, hit, vertex_normals)
    det = det._replace(valid=hit_valid)
    tex = apply_textures(scene, det)
    normal = tex.normal

    # Beer attenuation of the segment just resolved (det.t: the trace's t
    # recomputed on the tape, the same bits)
    if has_diel:
        seg_t = torch.where(hit_valid, det.t, 0.0)
        tput = tput * Vec3(torch.exp(-sigma.x * seg_t),
                           torch.exp(-sigma.y * seg_t),
                           torch.exp(-sigma.z * seg_t))

    # ---- emissions ----
    iter_key = rng.fold_in(key, it)
    mat_idx = det.mat
    mi = mat_idx.long()
    mtype = mats.mtype[mi]
    miss_primary = active & ~hit_valid & s.is_primary
    radiance = s.radiance + vwhere(miss_primary, bg, 0.0)
    replace_all = hit_valid & s.is_primary & (tex.dm == T.DECAL_REPLACE_ALL)
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
    net = s.net
    if net is not None:
        # one extension ray an active lane, one shadow ray a light for
        # each shaded lane
        net = net + active.sum() + n_shadow_lights(scene) * emits.sum()
    basic = direct_lighting(scene, sp_point, iter_key)
    radiance = radiance + vscrub_nan(vwhere(emits, tput * basic, 0.0))

    # ---- continuation rays ----
    eps = scene.shadow_eps
    wr = vreflect(d, normal)
    if scene.any_rough:
        chi = rng.uniform(rng.fold_in(iter_key, 7), (2, N), dev) - 0.5
        wr = _glossy_perturb(wr, mats.roughness[mi], mats.is_rough[mi],
                             chi[0], chi[1])
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

    return _State(
        active=continues, is_primary=torch.zeros_like(continues),
        o=vwhere(continues, new_o, o), d=vwhere(continues, new_d, d),
        tput=tput * vwhere(continues, w_next, 1.0),
        depth=torch.where(continues, depth - 1, depth),
        sigma=vwhere(continues, sigma_next, sigma), radiance=radiance,
        sp=sp, st_o=st_o, st_d=st_d, st_tput=st_tput, st_depth=st_depth,
        st_sigma=st_sigma, net=net)
