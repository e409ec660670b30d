"""The port's per-lane gathers and their backward (``ops/gather.py``).

- ``gather_rows`` gives ``table[idx]``'s bits and builds no graph where
  none is asked for. Its backward (a masked sum over the lanes a row for
  tables of up to ``SMALL_ROWS`` rows, sums over chunks of lanes and then
  over chunks for larger ones) equals the accumulating ``index_put_`` that
  ``table[idx]``'s backward is, at rtol 1e-6, with lanes spread over the
  rows and with 90% of them on row 0: rows no lane names stay 0, a NaN in
  one lane's gradient reaches only its own row, and two backwards give
  the same bits. In float32 the gradients are multiples of 1/64 whose
  partial sums are exact, so any order of summation gives the same sum;
  float64 cases take random normal gradients.
- ``intersect.hit_details`` under autograd (the triangle records and the
  sphere centres gathered through ``gather_rows``) gives the bits it gives
  without autograd, on scenes with misses, dead lanes and spheres, and
  vertex gradients equal to those of the plain gathers at rtol 1e-6,
  every one finite.
- A whole train step's loss is the same bits and its gradients match the
  plain gathers' at rtol 1e-5 (float32 sums in another order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

LANES = 4096


def _inputs(rows, cols, dtype, run0, seed=0):
    """A [rows, cols] table, [LANES] indices that never name the last row
    (and name row 0 on 90% of lanes when ``run0``), and a lane gradient."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(rows, cols))).to(dtype)
    idx = rng.integers(0, rows - 1, LANES)
    if run0:
        idx[rng.random(LANES) < 0.9] = 0
    if dtype == torch.float32:
        g = rng.integers(-64, 65, (LANES, cols)) / 64.0
    else:
        g = rng.normal(size=(LANES, cols))
    return table, torch.from_numpy(idx), torch.from_numpy(g).to(dtype)


def _index_put(rows, idx, g):
    return torch.zeros((rows,) + g.shape[1:], dtype=g.dtype).index_put_(
        (idx,), g, accumulate=True)


def _backward(table, idx, g):
    from raytracer795_tpu_torch.ops.gather import gather_rows

    leaf = table.clone().requires_grad_()
    (grad,) = torch.autograd.grad(gather_rows(leaf, idx), leaf, g)
    return grad


CASES = [(2, 3, torch.float32), (8, 31, torch.float32),
         (5, 3, torch.float64), (300, 31, torch.float32),
         (1000, 3, torch.float64)]


@pytest.mark.parametrize("rows,cols,dtype", CASES)
def test_forward_is_the_plain_gather(rows, cols, dtype):
    from raytracer795_tpu_torch.ops.gather import gather_rows

    table, idx, _ = _inputs(rows, cols, dtype, run0=False)
    want = table[idx]
    leaf = table.clone().requires_grad_()
    got = gather_rows(leaf, idx)
    assert type(got.grad_fn).__name__ == "_GatherRowsBackward"
    assert torch.equal(got.detach(), want)
    assert torch.equal(gather_rows(table, idx.to(torch.int32)), want)


def test_no_graph_builds_none():
    from raytracer795_tpu_torch.ops.gather import gather_rows

    for rows in (2, 300):
        table, idx, _ = _inputs(rows, 3, torch.float32, run0=False)
        leaf = table.clone().requires_grad_()
        assert gather_rows(table, idx).grad_fn is None
        with torch.no_grad():
            assert gather_rows(leaf, idx).grad_fn is None


@pytest.mark.parametrize("run0", [False, True], ids=["spread", "row0_run"])
@pytest.mark.parametrize("rows,cols,dtype", CASES)
def test_backward_equals_index_put(rows, cols, dtype, run0):
    table, idx, g = _inputs(rows, cols, dtype, run0)
    got = _backward(table, idx, g)
    want = _index_put(rows, idx, g)
    assert got.dtype == dtype and got.shape == table.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(got[-1], torch.zeros(cols, dtype=dtype))


@pytest.mark.parametrize("rows", [4, 300])
def test_nan_stays_in_its_row(rows):
    table, idx, g = _inputs(rows, 3, torch.float32, run0=True)
    lane = 17
    g[lane, 1] = float("nan")
    got = _backward(table, idx, g)
    want = _index_put(rows, idx, g)
    nan = torch.zeros(rows, 3, dtype=torch.bool)
    nan[idx[lane], 1] = True
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.isnan(want), nan)
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows", [8, 300])
def test_two_backwards_are_bit_equal(rows):
    table, idx, g = _inputs(rows, 31, torch.float32, run0=True, seed=3)
    g = g + torch.from_numpy(
        np.random.default_rng(4).normal(size=g.shape)).float()
    a, b = _backward(table, idx, g), _backward(table, idx, g)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _plain_gathers(monkeypatch):
    """The port's gathers as they were: ``table[idx]``."""
    from raytracer795_tpu_torch.models import brdf
    from raytracer795_tpu_torch.ops import intersect

    for module in (brdf, intersect):
        monkeypatch.setattr(module, "gather_rows", lambda t, i: t[i])


def _details_rays(scene, n, seed):
    """Rays from a box around the scene's vertices in all directions, so
    some hit and some miss; the first 1/8 are dead (d == 0)."""
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    rng = np.random.default_rng(seed)
    v = scene.vertices.detach().numpy()
    lo, hi = v.min(0), v.max(0)
    pad = 0.25 * (hi - lo)
    o = rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 8] = 0.0
    return intersect.Rays(o=Vec3.from_array(torch.from_numpy(o)),
                          d=Vec3.from_array(torch.from_numpy(d)),
                          time=torch.zeros(n))


def _float_fields(det):
    """Every float tensor of a HitDetails, Vec3 components included."""
    out = []
    for value in det:
        parts = value if isinstance(value, tuple) else (value,)
        for p in parts:
            if isinstance(p, tuple):
                continue                # minv_t: no vertex dependence
            if p.is_floating_point():
                out.append(p)
    return out


@pytest.mark.parametrize("name", ["cornellbox_pt", "ply_smooth"])
def test_hit_details_under_autograd(name, monkeypatch):
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.scene.loader import load_scene

    scene = load_scene(os.path.join(conftest.SCENES, name + ".xml"), "cpu",
                       bvh_min_tris=1).scene
    rays = _details_rays(scene, 2048, seed=1)
    hit = intersect.trace(scene, rays)
    sel = hit.valid & ~hit.is_sphere
    assert 0.05 < float(sel.float().mean()) < 0.8
    assert bool((hit.valid & hit.is_sphere).any()) == (name == "cornellbox_pt")
    weights = None

    def details():
        nonlocal weights
        verts = scene.vertices.detach().requires_grad_()
        sc = dataclasses.replace(scene, vertices=verts)
        det = intersect.hit_details(sc, rays, hit,
                                    intersect.compute_vertex_normals(sc))
        fields = _float_fields(det)
        if weights is None:
            rng = np.random.default_rng(2)
            weights = [torch.from_numpy(rng.normal(size=f.shape)).float()
                       for f in fields]
        loss = sum(torch.sum(w * f) for w, f in zip(weights, fields))
        (g,) = torch.autograd.grad(loss, verts)
        return [f.detach() for f in fields], g

    with torch.no_grad():
        want = _float_fields(intersect.hit_details(
            scene, rays, hit, intersect.compute_vertex_normals(scene)))
    got, g = details()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with monkeypatch.context() as m:
        _plain_gathers(m)
        _, g_plain = details()
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    torch.testing.assert_close(g, g_plain, rtol=1e-6,
                               atol=1e-6 * float(g_plain.abs().max()))


def _step_inputs(ld, res):
    """Center-of-pixel rays of a res x res band, their background, key 0
    and a target of 0.9 x the frame."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera, whitted
    from raytracer795_tpu_torch.utils import rng

    scene = ld.scene
    cam = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
    px, py = camera.band_pixels(res, res, scene.device)
    rays = camera.primary_rays_at(cam, px, py)
    bg = render._background_radiance(scene, cam, rays, px, py)
    key = rng.PRNGKey(0)
    with torch.no_grad():
        target = 0.9 * whitted.render_rays(scene, rays, bg, key)
    return rays, bg, key, target


def test_train_step_matches_plain_gathers(monkeypatch):
    from raytracer795_tpu_torch.parallel import shard as par
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(os.path.join(conftest.SCENES, "cornellbox.xml"), "cpu")
    rays, bg, key, target = _step_inputs(ld, 12)
    iters = par.resolve_whitted_iters(ld.scene, rays, bg, key)

    def step():
        loss, grads, _ = par.train_step_with_grads(
            ld.scene, rays, bg, target, key, lr=0.0, whitted_iters=iters)
        return loss, par._flat(grads)
    loss, grads = step()
    with monkeypatch.context() as m:
        _plain_gathers(m)
        loss_plain, grads_plain = step()
    assert torch.equal(loss, loss_plain)
    names = [k for k, v in par.differentiable_params(ld.scene).items()
             for _ in (v if isinstance(v, tuple) else (v,))]
    assert float(grads[names.index("diffuse")].abs().max()) > 0
    for name, g, gp in zip(names, grads, grads_plain):
        assert bool(torch.isfinite(g).all()), name
        scale = float(gp.abs().max()) if gp.numel() else 0.0
        torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-5 * scale,
                                   msg=name)
