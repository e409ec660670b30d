"""Wavefront intersection: ray batches against the scene's trace groups.

Counterpart of ``raytracer795_tpu/ops/intersect.py``. Phase 1 (``trace``,
``trace_anyhit``) finds each ray's nearest hit or any occluder per group
and reduces across groups; phase 2 (``hit_details``) recomputes geometric
attributes for each ray's single winning primitive.

Per group the path is fixed by the scene alone:
- a group with a ``FlatBVH`` walks it. On CUDA tensors that is the
  hand-written kernel of ops/bvh_traverse.py; on CPU tensors it is the
  plain walk of this module (``_tri_bvh_candidates`` / ``_tri_bvh_anyhit``),
  which is also what the kernels are held to;
- a group cut into packs (``pack_bvhs``) walks every pack: the multi-pack
  kernels on CUDA tensors, the plain walk over each pack in index order
  merged by a strict-less |t| key on CPU tensors
  (``_tri_bvh_candidates_multi`` / ``_tri_bvh_anyhit_multi``);
- groups that share a ``pack_share`` id (instances of one base mesh) are
  traced together: their local rays are concatenated into one query of
  the shared tables (``_pack_clusters``), which gives each group what its
  own query gives;
- other triangle groups sweep all triangles (``_tri_candidates``);
- spheres always sweep (``_sphere_candidates``).

Semantics kept from the reference, as in the JAX package: the triangle test
accepts t >= -int_eps, beta/gamma >= -int_eps, beta+gamma <= 1
(src/Shape.cpp:146-147); within a group the nearest hit is ranked by |t|
with strict-less updates (src/BVH.cpp:165-171); across groups world t must
be > 0 (src/Helper.cpp:43); NaN rays match nothing; transformed groups
intersect in local space without renormalizing the direction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from raytracer795_tpu_torch.ops.gather import gather_rows
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import (Mat3, Vec3, cdiv,
                                               const_affine_apply,
                                               const_mat3_apply, mwhere,
                                               vany_nan, vcross, vdot,
                                               sqrt, vmasked_normalize,
                                               vwhere)

_BIG = 3.0e38

# each scene's primitive offsets (``_prim_offsets``)
_OFFSETS = WeakIdKeyDictionary()

# Primitive-chunk width of the brute sweeps: bounds the [N, C] temporaries
# at the 2^18-lane bands of render.py. The chunking changes no result.
_PRIM_CHUNK = 32


class Rays(NamedTuple):
    o: Vec3             # [N] x3
    d: Vec3             # [N] x3
    time: torch.Tensor  # [N]


class Hit(NamedTuple):
    valid: torch.Tensor      # [N] bool
    t: torch.Tensor          # [N] world-space ray parameter
    group: torch.Tensor      # [N] int32 index into scene.groups
    prim: torch.Tensor       # [N] int32 index within the group's prim kind
    is_sphere: torch.Tensor  # [N] bool


class HitDetails(NamedTuple):
    valid: torch.Tensor
    point: Vec3             # world
    normal: Vec3            # LOCAL-space normal, normalized
    mat: torch.Tensor       # [N] int32
    t: torch.Tensor         # [N]
    tex0: torch.Tensor      # [N] int32 (-1 none)
    tex1: torch.Tensor      # [N] int32
    u: torch.Tensor
    v: torch.Tensor
    local_point: Vec3
    local_center: Vec3
    radius: torch.Tensor
    tri_e1: Vec3            # b - a (local)
    tri_e2: Vec3            # c - a (local)
    uv0u: torch.Tensor
    uv0v: torch.Tensor
    uv1u: torch.Tensor
    uv1v: torch.Tensor
    uv2u: torch.Tensor
    uv2v: torch.Tensor
    is_sphere: torch.Tensor
    minv_t: Mat3            # normal transform (rows) of the hit group
    emission: Vec3


def _transform_rays(group: T.TraceGroup, rays: Rays) -> Rays:
    """World ray -> group-local ray (src/Helper.cpp:110-133)."""
    if not group.has_xform and not group.has_blur:
        return rays
    blur = group.blur
    if group.has_blur:
        o = Vec3(rays.o.x - blur[0] * rays.time,
                 rays.o.y - blur[1] * rays.time,
                 rays.o.z - blur[2] * rays.time)
    else:
        o = rays.o
    if group.has_xform:
        m = group.minv
        o = const_affine_apply(m, o)
        d = const_mat3_apply(m, rays.d)
    else:
        d = rays.d
    return Rays(o=o, d=d, time=rays.time)


def _bbox_pass(group: T.TraceGroup, local: Rays) -> torch.Tensor:
    """Slab test of each source object's root bbox: [N, O+1] bool.

    BVH::RayBBoxIntersection (src/BVH.cpp:212-266): d == 0 falls into the
    negative branch and rejects the box through +/-inf (a reference quirk
    kept). Column O is always true, for single-primitive objects.
    """
    n_obj = group.obj_bbox.shape[0]
    o, d = local.o, local.d
    N = o.x.shape[0]
    cols = []
    for oi in range(n_obj):
        bmin = group.obj_bbox[oi, 0]
        bmax = group.obj_bbox[oi, 1]
        entry = torch.full((N,), -float("inf"), device=o.x.device)
        exit_ = torch.full((N,), float("inf"), device=o.x.device)
        for ox, dx, lo, hi in ((o.x, d.x, bmin[0], bmax[0]),
                               (o.y, d.y, bmin[1], bmax[1]),
                               (o.z, d.z, bmin[2], bmax[2])):
            pos = dx > 0
            t_e = torch.where(pos, (lo - ox) / dx, (hi - ox) / dx)
            t_l = torch.where(pos, (hi - ox) / dx, (lo - ox) / dx)
            entry = torch.maximum(entry, t_e)
            exit_ = torch.minimum(exit_, t_l)
        cols.append(~(exit_ < entry))
    cols.append(torch.ones((N,), dtype=torch.bool, device=o.x.device))
    return torch.stack(cols, dim=-1)


def tri_components(vertices: torch.Tensor, tri_vidx: torch.Tensor):
    """Per-triangle a, e1 = a-b, e2 = a-c, ng = e1 x e2 as Vec3 of [T].

    The reference's column setup (src/Shape.cpp:120-132), in the op order
    of the JAX package's ``_group_tri_tables`` and ``_tri_comps``.
    """
    a = Vec3.from_array(vertices[tri_vidx[:, 0].long()])
    b = Vec3.from_array(vertices[tri_vidx[:, 1].long()])
    c = Vec3.from_array(vertices[tri_vidx[:, 2].long()])
    e1 = a - b
    e2 = a - c
    return a, e1, e2, vcross(e1, e2)


def _tri_test(o: Vec3, d: Vec3, a: Vec3, e1: Vec3, e2: Vec3, ng: Vec3,
              int_eps):
    """Cramer solve of src/Shape.cpp:120-132. Returns (accept, t)."""
    ao = a - o
    e2xd = vcross(e2, d)
    det = vdot(e1, e2xd)
    inv_det = 1.0 / det
    beta = vdot(ao, e2xd) * inv_det
    e1xd = vcross(e1, d)
    gamma = -vdot(ao, e1xd) * inv_det
    t = vdot(ng, ao) * inv_det
    ok = ((t >= -int_eps) & (beta >= -int_eps) & (gamma >= -int_eps)
          & (beta + gamma <= 1.0))
    return ok, t


def _chunk3(v: Vec3, sl) -> Vec3:
    return Vec3(v.x[sl][None, :], v.y[sl][None, :], v.z[sl][None, :])


def _col3(v: Vec3) -> Vec3:
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def _tri_candidates(scene: T.Scene, group: T.TraceGroup, local: Rays,
                    bbox_ok: torch.Tensor):
    """Nearest triangle per ray by a chunked sweep: (|t| key, t, prim).

    Within a chunk the first minimal key wins; across chunks strict-less:
    the sequential strict-less scan of the JAX package, in fewer ops.
    """
    av, e1v, e2v, ngv = tri_components(scene.vertices, group.tri_vidx)
    int_eps = scene.int_eps
    o, d = _col3(local.o), _col3(local.d)
    N = local.o.x.shape[0]
    dev = local.o.x.device
    best_key = torch.full((N,), _BIG, device=dev)
    best_t = torch.zeros((N,), device=dev)
    best_idx = torch.zeros((N,), dtype=torch.int32, device=dev)
    n_obj = bbox_ok.shape[1] - 1
    obj_all = torch.where(group.tri_obj < 0, n_obj, group.tri_obj).long()

    for start in range(0, group.n_tris, _PRIM_CHUNK):
        sl = slice(start, min(start + _PRIM_CHUNK, group.n_tris))
        ok, t = _tri_test(o, d, _chunk3(av, sl), _chunk3(e1v, sl),
                          _chunk3(e2v, sl), _chunk3(ngv, sl), int_eps)
        ok = ok & bbox_ok[:, obj_all[sl]]
        key = torch.where(ok, torch.abs(t), _BIG)
        ckey, ci = torch.min(key, dim=-1)
        ct = torch.gather(t, 1, ci[:, None])[:, 0]
        upd = ckey < best_key
        best_t = torch.where(upd, ct, best_t)
        best_idx = torch.where(upd, ci.to(torch.int32) + start, best_idx)
        best_key = torch.minimum(best_key, ckey)
    return best_key, best_t, best_idx


def _sphere_test(o: Vec3, d: Vec3, cx, cy, cz, r, int_eps):
    """Quadratic of src/Shape.cpp:347-388 on component arrays."""
    ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
    dd = d.x * d.x + d.y * d.y + d.z * d.z
    b = d.x * ocx + d.y * ocy + d.z * ocz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - dd * cq
    ok = disc >= int_eps
    sq = sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b + sq) / dd
    t2 = (-b - sq) / dd
    # sign cases (src/Shape.cpp:365-388)
    t = torch.where((t1 >= 0) & (t2 < 0), t1,
                    torch.where((t2 >= 0) & (t1 < 0), t2,
                                torch.minimum(t1, t2)))
    ok = ok & ~((t1 < 0) & (t2 < 0))
    return ok, t


def _sphere_candidates(scene: T.Scene, group: T.TraceGroup, local: Rays
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest sphere per ray; the first minimal |t| key wins."""
    centers = scene.vertices[group.sph_cidx.long()]        # [S, 3]
    radii = group.sph_radius
    ok, t = _sphere_test(_col3(local.o), _col3(local.d), centers[None, :, 0],
                         centers[None, :, 1], centers[None, :, 2],
                         radii[None, :], scene.int_eps)
    key = torch.where(ok, torch.abs(t), _BIG)
    skey, si = torch.min(key, dim=-1)
    st = torch.gather(t, 1, si[:, None])[:, 0]
    return skey, st, si.to(torch.int32)


def _slab_test(o: Vec3, d: Vec3, inv_d: Vec3, bmin: Vec3, bmax: Vec3):
    """Reference slab test (src/BVH.cpp:212-266) on per-lane boxes.

    ``torch.maximum``/``minimum`` propagate NaN like ``jnp.maximum``, so a
    d == 0 lane rejects through inf/NaN exactly as in the JAX package.
    Returns (box_hit, entry distance).
    """
    entry = torch.full_like(o.x, -float("inf"))
    exit_ = torch.full_like(o.x, float("inf"))
    for ox, dx, ix, lo, hi in ((o.x, d.x, inv_d.x, bmin.x, bmax.x),
                               (o.y, d.y, inv_d.y, bmin.y, bmax.y),
                               (o.z, d.z, inv_d.z, bmin.z, bmax.z)):
        pos = dx > 0
        t_e = torch.where(pos, (lo - ox) * ix, (hi - ox) * ix)
        t_l = torch.where(pos, (hi - ox) * ix, (lo - ox) * ix)
        entry = torch.maximum(entry, t_e)
        exit_ = torch.minimum(exit_, t_l)
    return ~(exit_ < entry), entry


def _gather3(tbl: Vec3, idx) -> Vec3:
    return Vec3(tbl.x[idx], tbl.y[idx], tbl.z[idx])


def _contig(v: Vec3) -> Vec3:
    return Vec3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())


def _dead_lanes(o: Vec3, d: Vec3):
    """NaN rays and all-zero directions never hit (src/Helper.cpp:28-30)."""
    return (vany_nan(o) | vany_nan(d)
            | ((d.x == 0.0) & (d.y == 0.0) & (d.z == 0.0)))


class _Walk:
    """Per-lane skip-link walk state, compacted to the lanes still walking.

    Every lane's node sequence depends on its own ray and best hit only, so
    dropping finished lanes from the tensors changes no lane's result: this
    is the JAX package's lockstep ``while_loop`` without the idle lanes.
    """

    def __init__(self, tables, o: Vec3, d: Vec3, int_eps):
        self.tb = tables
        self.int_eps = int_eps
        self.lane = torch.nonzero(~_dead_lanes(o, d))[:, 0]
        self.o = _gather3(o, self.lane)
        self.d = _gather3(d, self.lane)
        self.inv_d = Vec3(1.0 / self.d.x, 1.0 / self.d.y, 1.0 / self.d.z)
        self.node = torch.zeros_like(self.lane)

    def visit(self):
        """Slab test of every lane's current node: (box_hit, entry, leaf)."""
        tb, ni = self.tb, self.node
        box_hit, entry = _slab_test(self.o, self.d, self.inv_d,
                                    _gather3(tb.bmin, ni),
                                    _gather3(tb.bmax, ni))
        return box_hit, entry, tb.count[ni] > 0

    def leaf_tests(self, li):
        """Triangle tests of the leaves of lanes ``li``: (ok, t, prim) [L, K]."""
        tb = self.tb
        ni = self.node[li]
        j = torch.arange(tb.max_leaf, device=ni.device)
        pi = tb.first[ni].long()[:, None] + j[None, :]
        in_leaf = j[None, :] < tb.count[ni][:, None]
        pi = torch.clamp(pi, 0, tb.a.x.shape[0] - 1)
        ok, t = _tri_test(_col3(_gather3(self.o, li)),
                          _col3(_gather3(self.d, li)), _gather3(tb.a, pi),
                          _gather3(tb.e1, pi), _gather3(tb.e2, pi),
                          _gather3(tb.ng, pi), self.int_eps)
        return ok & in_leaf, t, pi

    def advance(self, descend):
        ni = self.node
        self.node = torch.where(descend, ni + 1, self.tb.miss[ni].long())

    def retire(self, done, *state):
        """Drop the lanes in ``done``; returns (their lane ids, states)."""
        keep = ~done
        out = (self.lane[done],) + tuple(s[done] for s in state)
        self.lane = self.lane[keep]
        self.o = _gather3(self.o, keep)
        self.d = _gather3(self.d, keep)
        self.inv_d = _gather3(self.inv_d, keep)
        self.node = self.node[keep]
        return out, tuple(s[keep] for s in state)


def _tri_bvh_candidates(tables, o: Vec3, d: Vec3, int_eps):
    """Nearest triangle per ray over a flat BVH: the plain walk.

    A port of the JAX package's ``_tri_bvh_candidates`` (stackless
    skip-link walk, one node per lane per step): the slab test with its
    d == 0 quirk, the ``entry > best |t|`` prune, leaf triangles tested in
    order with strict-less |t| updates, NaN and zero-direction rays dead on
    arrival. ``tables`` is the decoded form of the kernel tables
    (ops/bvh_traverse.py ``TraverseTables.decode``). Returns
    (|t| key, t, prim index in BVH order), key 3e38 on a miss.
    """
    N = o.x.shape[0]
    dev = o.x.device
    best_key = torch.full((N,), _BIG, device=dev)
    best_t = torch.zeros((N,), device=dev)
    best_idx = torch.zeros((N,), dtype=torch.int32, device=dev)
    w = _Walk(tables, o, d, int_eps)
    n = w.lane.shape[0]
    key = torch.full((n,), _BIG, device=dev)
    t = torch.zeros((n,), device=dev)
    idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    while w.lane.shape[0]:
        box_hit, entry, is_leaf = w.visit()
        box_hit = box_hit & ~(entry > key)              # safe |t| prune
        li = torch.nonzero(box_hit & is_leaf)[:, 0]
        if li.shape[0]:
            ok, tt, pi = w.leaf_tests(li)
            k = torch.where(ok, torch.abs(tt), _BIG)
            ck, cj = torch.min(k, dim=1)
            upd = ck < key[li]
            key[li] = torch.where(upd, ck, key[li])
            t[li] = torch.where(upd, torch.gather(tt, 1, cj[:, None])[:, 0],
                                t[li])
            idx[li] = torch.where(
                upd, torch.gather(pi, 1, cj[:, None])[:, 0].to(torch.int32),
                idx[li])
        w.advance(box_hit & ~is_leaf)
        done = w.node >= tables.n_nodes
        (lanes, k_d, t_d, i_d), (key, t, idx) = w.retire(done, key, t, idx)
        best_key[lanes], best_t[lanes], best_idx[lanes] = k_d, t_d, i_d
    return best_key, best_t, best_idx


def _tri_bvh_anyhit(tables, o: Vec3, d: Vec3, t_cap: torch.Tensor,
                    int_eps):
    """Any accepted triangle with t in (0, t_cap)? The plain walk.

    A port of the JAX package's ``_tri_bvh_anyhit``: the nearest walk with
    an ``entry > t_cap`` prune and a lane retiring at its first qualifying
    hit. ``t_cap`` is [N]. Returns [N] bool.
    """
    N = o.x.shape[0]
    found = torch.zeros((N,), dtype=torch.bool, device=o.x.device)
    w = _Walk(tables, o, d, int_eps)
    cap = t_cap[w.lane]
    got = torch.zeros_like(cap, dtype=torch.bool)
    while w.lane.shape[0]:
        box_hit, entry, is_leaf = w.visit()
        box_hit = box_hit & ~(entry > cap)
        li = torch.nonzero(box_hit & is_leaf)[:, 0]
        if li.shape[0]:
            ok, tt, _ = w.leaf_tests(li)
            c = cap[li][:, None]
            got[li] = torch.any(ok & (tt > 0) & (tt < c), dim=1)
        w.advance(box_hit & ~is_leaf)
        done = got | (w.node >= tables.n_nodes)
        (lanes, _, g_d), (cap, got) = w.retire(done, cap, got)
        found[lanes] = g_d
    return found


def _tri_bvh_candidates_multi(packs, o: Vec3, d: Vec3, int_eps):
    """Nearest triangle over a group's packs: the plain walk.

    The JAX package's per-pack fallback (its ops/intersect.py:618-628):
    each pack walked on its own by ``_tri_bvh_candidates`` (``packs`` are
    decoded per-pack tables over the group's one triangle table), merged in
    pack order with a strict-less |t| key.
    """
    key, t, idx = _tri_bvh_candidates(packs[0], o, d, int_eps)
    for pk in packs[1:]:
        k2, t2, i2 = _tri_bvh_candidates(pk, o, d, int_eps)
        upd = k2 < key
        t = torch.where(upd, t2, t)
        idx = torch.where(upd, i2, idx)
        key = torch.minimum(key, k2)
    return key, t, idx


def _tri_bvh_anyhit_multi(packs, o: Vec3, d: Vec3, t_cap: torch.Tensor,
                          int_eps):
    """Any-hit over a group's packs: the plain walk of each pack, OR-ed
    (the JAX package's ops/intersect.py:756-760)."""
    found = torch.zeros_like(o.x, dtype=torch.bool)
    for pk in packs:
        found = found | _tri_bvh_anyhit(pk, o, d, t_cap, int_eps)
    return found


def _bvh_nearest(scene: T.Scene, group: T.TraceGroup, o: Vec3, d: Vec3):
    """(key, t, prim) of a BVH or multi-pack group for local rays."""
    from raytracer795_tpu_torch.ops import bvh_traverse as bt

    if group.bvh is not None:
        return bt.tri_bvh_nearest(
            bt.build_tables(group.bvh, scene.vertices, group.tri_vidx),
            o, d, scene.int_eps)
    return bt.tri_bvh_nearest_multi(
        bt.build_multi_tables(group.pack_bvhs, scene.vertices,
                              group.tri_vidx), o, d, scene.int_eps)


def _bvh_anyhit(scene: T.Scene, group: T.TraceGroup, o: Vec3, d: Vec3,
                t_cap: torch.Tensor) -> torch.Tensor:
    """Any-hit of a BVH or multi-pack group for local rays."""
    from raytracer795_tpu_torch.ops import bvh_traverse as bt

    if group.bvh is not None:
        return bt.tri_bvh_anyhit(
            bt.build_tables(group.bvh, scene.vertices, group.tri_vidx),
            o, d, t_cap, scene.int_eps)
    return bt.tri_bvh_anyhit_multi(
        bt.build_multi_tables(group.pack_bvhs, scene.vertices,
                              group.tri_vidx), o, d, t_cap, scene.int_eps)


def _has_bvh(group: T.TraceGroup) -> bool:
    return group.bvh is not None or group.pack_bvhs is not None


def _pack_clusters(scene: T.Scene):
    """Indices of the groups that share traversal tables (instances of a
    base mesh: the loader's ``pack_share`` ids), by id, where two or more
    share them (the JAX package's ops/intersect.py:490-502)."""
    clusters = {}
    for gi, group in enumerate(scene.groups):
        if _has_bvh(group) and group.pack_share >= 0:
            clusters.setdefault(group.pack_share, []).append(gi)
    return {s: gis for s, gis in clusters.items() if len(gis) > 1}


def _concat_local_rays(scene: T.Scene, gis, rays: Rays):
    """Each group's local rays, stacked on the lane axis: [G*N] each."""
    locs = [_transform_rays(scene.groups[gi], rays) for gi in gis]
    o = Vec3(*(torch.cat([getattr(lc.o, c) for lc in locs]) for c in "xyz"))
    d = Vec3(*(torch.cat([getattr(lc.d, c) for lc in locs]) for c in "xyz"))
    return o, d


def _batched_nearest(scene: T.Scene, gis, rays: Rays):
    """One query of the shared tables for every group of a cluster.

    The reference walks instances one after another (src/Helper.cpp:53-73);
    here the wavefront goes into every instance's local space and the
    concatenated lanes run once. A lane's result does not depend on the
    others, so each group gets what its own query gives. Returns [G, N]
    (key, t, prim).
    """
    n = rays.o.x.shape[0]
    o, d = _concat_local_rays(scene, gis, rays)
    k, t, i = _bvh_nearest(scene, scene.groups[gis[0]], o, d)
    g = len(gis)
    return k.reshape(g, n), t.reshape(g, n), i.reshape(g, n)


def _batched_anyhit(scene: T.Scene, gis, rays: Rays, t_cap: torch.Tensor):
    """Occlusion analogue of ``_batched_nearest``: [G, N] found."""
    n = rays.o.x.shape[0]
    o, d = _concat_local_rays(scene, gis, rays)
    cap = t_cap.repeat(len(gis))
    return _bvh_anyhit(scene, scene.groups[gis[0]], o, d, cap).reshape(
        len(gis), n)


def trace(scene: T.Scene, rays: Rays) -> Hit:
    """Nearest hit over all groups (world dispatch, src/Helper.cpp:18-80).

    Which primitive a ray hits is a discrete decision, so the query runs
    without autograd; ``hit_details`` recomputes the winner's geometry.
    """
    with torch.no_grad():
        N = rays.o.x.shape[0]
        dev = rays.o.x.device
        best_t = torch.full((N,), _BIG, device=dev)
        best_group = torch.zeros((N,), dtype=torch.int32, device=dev)
        best_prim = torch.zeros((N,), dtype=torch.int32, device=dev)
        best_sph = torch.zeros((N,), dtype=torch.bool, device=dev)
        valid = torch.zeros((N,), dtype=torch.bool, device=dev)

        batched = {}
        for gis in _pack_clusters(scene).values():
            bk, bt, bi = _batched_nearest(scene, gis, rays)
            for slot, gi in enumerate(gis):
                batched[gi] = (bk[slot], bt[slot], bi[slot])

        for gi, group in enumerate(scene.groups):
            if gi in batched and not group.n_spheres:
                local = None        # the cluster's query transformed them
            else:
                local = _transform_rays(group, rays)
            g_key = torch.full((N,), _BIG, device=dev)
            g_t = torch.zeros((N,), device=dev)
            g_prim = torch.zeros((N,), dtype=torch.int32, device=dev)
            g_sph = torch.zeros((N,), dtype=torch.bool, device=dev)
            if group.n_tris:
                if gi in batched:
                    tk, tt, tidx = batched[gi]
                elif _has_bvh(group):
                    tk, tt, tidx = _bvh_nearest(scene, group,
                                                _contig(local.o),
                                                _contig(local.d))
                else:
                    bbox_ok = _bbox_pass(group, local)
                    tk, tt, tidx = _tri_candidates(scene, group, local,
                                                   bbox_ok)
                g_key, g_t, g_prim = tk, tt, tidx
            if group.n_spheres:
                sk, st, sidx = _sphere_candidates(scene, group, local)
                upd = sk < g_key
                g_t = torch.where(upd, st, g_t)
                g_prim = torch.where(upd, sidx, g_prim)
                g_sph = upd | (group.n_tris == 0)
                g_key = torch.minimum(g_key, sk)
            # world-level accept: t > 0 and nearer (src/Helper.cpp:43)
            ok = (g_key < _BIG) & (g_t > 0) & (g_t < best_t)
            best_t = torch.where(ok, g_t, best_t)
            best_group = torch.where(ok, gi, best_group)
            best_prim = torch.where(ok, g_prim, best_prim)
            best_sph = torch.where(ok, g_sph, best_sph)
            valid = valid | ok

    return Hit(valid=valid, t=best_t, group=best_group, prim=best_prim,
               is_sphere=best_sph)


def trace_anyhit(scene: T.Scene, rays: Rays, t_cap) -> torch.Tensor:
    """Occlusion query: any primitive with world t in (0, t_cap)? [N] bool.

    Documented departure, as in the JAX package: the reference shadows via
    the full nearest-hit dispatch, whose |t| ranking can let a backface at
    negative t mask a real positive-t occluder (src/BVH.cpp:165-171); the
    any-hit reports the occluder.
    """
    with torch.no_grad():
        N = rays.o.x.shape[0]
        dev = rays.o.x.device
        # a Python cap is filled on the device: no host-to-device copy
        t_cap = (torch.broadcast_to(t_cap, (N,)).contiguous()
                 if isinstance(t_cap, torch.Tensor) else
                 torch.full((N,), float(t_cap), device=dev))
        found = torch.zeros((N,), dtype=torch.bool, device=dev)
        batched = set()
        for gis in _pack_clusters(scene).values():
            found = found | torch.any(
                _batched_anyhit(scene, gis, rays, t_cap), dim=0)
            batched.update(gis)
        for gi, group in enumerate(scene.groups):
            if gi in batched and not group.n_spheres:
                continue            # traced with its cluster
            local = _transform_rays(group, rays)
            if group.n_tris and gi not in batched:
                if _has_bvh(group):
                    found = found | _bvh_anyhit(scene, group,
                                                _contig(local.o),
                                                _contig(local.d), t_cap)
                else:
                    bbox_ok = _bbox_pass(group, local)
                    k, t, _ = _tri_candidates(scene, group, local, bbox_ok)
                    found = found | ((k < _BIG) & (t > 0) & (t < t_cap))
            if group.n_spheres:
                k, t, _ = _sphere_candidates(scene, group, local)
                found = found | ((k < _BIG) & (t > 0) & (t < t_cap))
    return found


def compute_vertex_normals(scene: T.Scene) -> torch.Tensor:
    """Accumulate flat normals of smooth triangles onto vertices.

    Scene::renderScene's vertex-normal pass (src/Scene.cpp:302-318,
    src/Shape.cpp:262-276): per smooth triangle add normalize((c-b)x(a-b))
    to its three vertices, then normalize per vertex. On the tape, so
    vertex gradients reach the shading normals. Each vertex adds its
    triangles in triangle order, so a frame is the same bits every time:
    ``index_add`` does so on the CPU, but adds with atomics on CUDA, where
    an accumulating ``index_put`` sorts instead (and on the CPU, with
    several threads, it does not keep the order). Without autograd, CUDA
    takes that kernel without its index range check, which reads the
    indices' bounds back to the host: a captured graph could not hold it,
    and the indices are the scene's own.
    """
    verts = scene.vertices
    acc = torch.zeros_like(verts)
    for group in scene.groups:
        if not group.n_tris:
            continue
        vidx = group.tri_vidx.long()
        a = verts[vidx[:, 0]]
        b = verts[vidx[:, 1]]
        c = verts[vidx[:, 2]]
        n = torch.stack(vcross(Vec3.from_array(c - b),
                               Vec3.from_array(a - b)), dim=-1)
        sq = (n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
              + n[:, 2] * n[:, 2])[:, None]
        n = n / sqrt(torch.where(sq > 0, sq, 1.0))
        w = (group.tri_smooth & (sq[:, 0] > 0)).to(verts.dtype)[:, None]
        n = n * w
        for k in range(3):
            if verts.device.type == "cuda" and not torch.is_grad_enabled():
                acc = torch.ops.aten._index_put_impl_(
                    acc, [vidx[:, k]], n, accumulate=True, unsafe=True)
            elif verts.device.type == "cuda":
                acc = acc.index_put((vidx[:, k],), n, accumulate=True)
            else:
                acc = acc.index_add(0, vidx[:, k], n)
    sq = (acc[:, 0] * acc[:, 0] + acc[:, 1] * acc[:, 1]
          + acc[:, 2] * acc[:, 2])[:, None]
    return acc / sqrt(torch.where(sq > 0, sq, 1.0))


def _prim_offsets(scene: T.Scene):
    """Each group's first triangle and first sphere in the concatenated
    tables, [G + 1] int64 each on the scene's device: copied there once
    per scene, so ``hit_details`` makes no host-to-device copy (which a
    captured graph could not hold)."""
    got = _OFFSETS.get(scene)
    if got is None:
        got = _OFFSETS[scene] = tuple(
            torch.as_tensor(np.cumsum([0] + [getattr(gr, n) for gr in
                                             scene.groups]),
                            dtype=torch.int64, device=scene.device)
            for n in ("n_tris", "n_spheres"))
    return got


def hit_details(scene: T.Scene, rays: Rays, hit: Hit,
                vertex_normals: torch.Tensor) -> HitDetails:
    """Phase 2: full geometric attributes for each ray's winning primitive.

    One gather pass over concatenated per-group primitive tables, indexed
    by ``offset[group] + prim``; t, barycentrics and the sphere quadratic
    are recomputed for the winner in the trace's op order.
    """
    N = rays.o.x.shape[0]
    dev = rays.o.x.device
    zero = torch.zeros((N,), device=dev)
    zeros3 = Vec3(zero, zero, zero)
    t0 = torch.where(hit.valid, hit.t, 1.0)
    out = HitDetails(
        valid=hit.valid,
        point=rays.o + rays.d * t0,                 # world (Helper.cpp:47)
        normal=zeros3, mat=torch.zeros((N,), dtype=torch.int32, device=dev),
        t=t0,
        tex0=torch.full((N,), -1, dtype=torch.int32, device=dev),
        tex1=torch.full((N,), -1, dtype=torch.int32, device=dev),
        u=zero, v=zero, local_point=zeros3, local_center=zeros3,
        radius=zero, tri_e1=zeros3, tri_e2=zeros3,
        uv0u=zero, uv0v=zero, uv1u=zero, uv1v=zero, uv2u=zero, uv2v=zero,
        is_sphere=hit.is_sphere,
        minv_t=Mat3.identity_like(N, dev),
        emission=zeros3,
    )

    verts = scene.vertices
    groups = scene.groups
    if not groups:
        return out
    g = hit.group.long()

    static_world = all(not gr.has_xform and not gr.has_blur for gr in groups)
    if static_world:
        local_o, local_d = rays.o, rays.d
        lane_minv_t = out.minv_t
    else:
        minv = torch.stack([gr.minv.reshape(16) for gr in groups])
        minv_t3 = torch.stack([gr.minv_t[:3, :3].reshape(9) for gr in groups])
        blur = torch.stack([gr.blur for gr in groups])
        mrec = minv[g]          # [N, 16]
        trec = minv_t3[g]       # [N, 9]
        brec = blur[g]          # [N, 3]
        o_b = Vec3(rays.o.x - brec[:, 0] * rays.time,
                   rays.o.y - brec[:, 1] * rays.time,
                   rays.o.z - brec[:, 2] * rays.time)

        def lane_mat3(rec, stride):
            return Mat3(
                Vec3(rec[:, 0], rec[:, 1], rec[:, 2]),
                Vec3(rec[:, stride], rec[:, stride + 1], rec[:, stride + 2]),
                Vec3(rec[:, 2 * stride], rec[:, 2 * stride + 1],
                     rec[:, 2 * stride + 2]))

        mv3 = lane_mat3(mrec, 4)
        local_o = mv3.apply(o_b) + Vec3(mrec[:, 3], mrec[:, 7], mrec[:, 11])
        local_d = mv3.apply(rays.d)
        lane_minv_t = lane_mat3(trec, 3)

    tri_offs, sph_offs = _prim_offsets(scene)
    n_tris_total = sum(gr.n_tris for gr in groups)
    n_sph_total = sum(gr.n_spheres for gr in groups)

    def concat(field, kind):
        return torch.cat([getattr(gr, field) for gr in groups
                          if getattr(gr, kind)], dim=0)

    if n_tris_total:
        sel = hit.valid & ~hit.is_sphere
        tid = torch.clamp(tri_offs[g] + hit.prim, 0, n_tris_total - 1)
        # one [T, 31] record per triangle, gathered once per lane
        vidx_t = concat("tri_vidx", "n_tris").long()
        i0t, i1t, i2t = vidx_t[:, 0], vidx_t[:, 1], vidx_t[:, 2]
        uvoff_t = concat("tri_uvoff", "n_tris").long()
        texcoords = scene.texcoords
        ntc = texcoords.shape[0]
        j0t = torch.clamp(i0t + uvoff_t, 0, ntc - 1)
        j1t = torch.clamp(i1t + uvoff_t, 0, ntc - 1)
        j2t = torch.clamp(i2t + uvoff_t, 0, ntc - 1)

        def col(x):
            return x.to(torch.float32)[:, None]

        table = torch.cat([
            verts[i0t], verts[i1t], verts[i2t],             # a b c   0:9
            vertex_normals[i0t], vertex_normals[i1t],
            vertex_normals[i2t],                            # n0..n2  9:18
            texcoords[j0t], texcoords[j1t], texcoords[j2t],  # uv     18:24
            concat("tri_emis", "n_tris"),                   # emis   24:27
            col(concat("tri_smooth", "n_tris")),            # 27
            col(concat("tri_mat", "n_tris")),               # 28 (ids exact
            col(concat("tri_tex0", "n_tris")),              # 29  in f32)
            col(concat("tri_tex1", "n_tris")),              # 30
        ], dim=1)
        # a lane's record; every miss and dead lane reads row 0, and a
        # large triangle many lanes, so the backward sums in chunks
        rec = gather_rows(table, tid)                       # [N, 31]

        def v3(k):
            return Vec3(rec[:, k], rec[:, k + 1], rec[:, k + 2])

        a, b, c = v3(0), v3(3), v3(6)
        # the trace's Cramer system again (src/Shape.cpp:120-132), same op
        # order as _tri_test, so t has the trace's bits
        e1, e2 = a - b, a - c
        e2xd = vcross(e2, local_d)
        det = vdot(e1, e2xd)
        inv_det = 1.0 / torch.where(det != 0, det, 1.0)
        ao = a - local_o
        beta = vdot(ao, e2xd) * inv_det
        e1xd = vcross(e1, local_d)
        gamma = -vdot(ao, e1xd) * inv_det
        t_tri = vdot(vcross(e1, e2), ao) * inv_det
        alpha = 1.0 - beta - gamma
        lpoint = local_o + local_d * t_tri
        smooth = rec[:, 27] != 0
        n_flat = vcross(c - b, a - b)
        n_smooth = v3(9) * alpha + v3(12) * beta + v3(15) * gamma
        n = vwhere(smooth, n_smooth, n_flat)
        n = vmasked_normalize(sel, n)
        u0, v0 = rec[:, 18], rec[:, 19]
        u1, v1 = rec[:, 20], rec[:, 21]
        u2, v2 = rec[:, 22], rec[:, 23]
        uu = u0 * alpha + u1 * beta + u2 * gamma
        vv = v0 * alpha + v1 * beta + v2 * gamma
        out = out._replace(
            point=vwhere(sel, rays.o + rays.d * t_tri, out.point),
            t=torch.where(sel, t_tri, out.t),
            normal=vwhere(sel, n, out.normal),
            mat=torch.where(sel, rec[:, 28].to(torch.int32), out.mat),
            tex0=torch.where(sel, rec[:, 29].to(torch.int32), out.tex0),
            tex1=torch.where(sel, rec[:, 30].to(torch.int32), out.tex1),
            u=torch.where(sel, uu, out.u),
            v=torch.where(sel, vv, out.v),
            local_point=vwhere(sel, lpoint, out.local_point),
            tri_e1=vwhere(sel, b - a, out.tri_e1),
            tri_e2=vwhere(sel, c - a, out.tri_e2),
            uv0u=torch.where(sel, u0, out.uv0u),
            uv0v=torch.where(sel, v0, out.uv0v),
            uv1u=torch.where(sel, u1, out.uv1u),
            uv1v=torch.where(sel, v1, out.uv1v),
            uv2u=torch.where(sel, u2, out.uv2u),
            uv2v=torch.where(sel, v2, out.uv2v),
            minv_t=mwhere(sel, lane_minv_t, out.minv_t),
            emission=vwhere(sel, v3(24), out.emission),
        )

    if n_sph_total:
        sel = hit.valid & hit.is_sphere
        sid = torch.clamp(sph_offs[g] + hit.prim, 0, n_sph_total - 1)
        # the S centres first, then a lane's: a gather from the S rows of
        # the centres, not from the vertex table
        center = Vec3.from_array(gather_rows(
            verts[concat("sph_cidx", "n_spheres").long()], sid))
        radius = concat("sph_radius", "n_spheres")[sid]
        # the winner's t again (quadratic of src/Shape.cpp:347-388)
        oc = local_o - center
        dd = vdot(local_d, local_d)
        bq = vdot(local_d, oc)
        cq = vdot(oc, oc) - radius * radius
        disc = bq * bq - dd * cq
        sq = sqrt(torch.where(disc > 0, disc, 1.0)) * (disc > 0)
        inv_dd = 1.0 / torch.where(dd != 0, dd, 1.0)
        t1 = (-bq + sq) * inv_dd
        t2 = (-bq - sq) * inv_dd
        t_sph = torch.where((t1 >= 0) & (t2 < 0), t1,
                            torch.where((t2 >= 0) & (t1 < 0), t2,
                                        torch.minimum(t1, t2)))
        lpoint = local_o + local_d * t_sph
        lc = lpoint - center
        n = vmasked_normalize(sel, lc)      # local-space normal
        # sphere UV from local spherical coords (src/Shape.cpp:413-417)
        cos_theta = torch.clamp(lc.y / torch.where(radius > 0, radius, 1.0),
                                -1.0, 1.0)
        theta = torch.arccos(torch.where(sel, cos_theta, 0.0))
        phi = torch.atan2(lc.z, torch.where(sel, lc.x, 1.0))
        uu = cdiv(-phi + np.pi, 2.0 * np.pi)
        vv = cdiv(theta, np.pi)
        emis = Vec3.from_array(concat("sph_emis", "n_spheres")[sid])
        out = out._replace(
            point=vwhere(sel, rays.o + rays.d * t_sph, out.point),
            t=torch.where(sel, t_sph, out.t),
            normal=vwhere(sel, n, out.normal),
            mat=torch.where(sel, concat("sph_mat", "n_spheres")[sid],
                            out.mat),
            tex0=torch.where(sel, concat("sph_tex0", "n_spheres")[sid],
                             out.tex0),
            tex1=torch.where(sel, concat("sph_tex1", "n_spheres")[sid],
                             out.tex1),
            u=torch.where(sel, uu, out.u),
            v=torch.where(sel, vv, out.v),
            local_point=vwhere(sel, lpoint, out.local_point),
            local_center=vwhere(sel, center, out.local_center),
            radius=torch.where(sel, radius, out.radius),
            minv_t=mwhere(sel, lane_minv_t, out.minv_t),
            emission=vwhere(sel, emis, out.emission),
        )

    return out
