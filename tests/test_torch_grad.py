"""Pixel gradients of the port's Whitted lane machine, against the JAX package.

- ``render_rays(..., differentiable=True)`` gives the ``differentiable=False``
  frame bit for bit, and ``forward_iteration_count`` the JAX package's count
  (cornellbox D=6 with its dielectric at 24x24, and textures at 32x32).
- Gradients of one MSE loss against a fixed target equal ``jax.grad`` of the
  same loss on the same scene, rays and key, per parameter family at
  rtol=2e-3, atol=2e-3 * max|g_jax| (the bound of
  tests/test_parallel.py:94-96): cornellbox's diffuse, specular, mirror,
  ambient, point_intensity and vertices, and textures' kd-decal images. The
  JAX side is computed once per scene with one ``jax.jit(jax.value_and_grad)``.
- The finite-difference checks of tests/test_grad.py, on the port (eager, no
  compile): diffuse and point light at 2%, per-material locality, per-texel
  at 2% on the 3 strongest texels; the bump-texture check of
  tests/test_tpu.py:143-198 (the 2 strongest bump texels at 5%), which the
  JAX package can run only on a TPU; and a vertex check: one mesh's vertices
  moved along a seeded direction under which every test pixel keeps its
  winning primitive, through the BVH walk, central FD within 2%.
- The traversal tables hold no autograd graph even when the vertices
  require grad, and a vertex moved in place still gives fresh hits.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

RTOL = 2e-3     # and atol = RTOL * max|g_jax|, tests/test_parallel.py:94-96
TARGET = 0.25   # the fixed MSE target of tests/test_parallel.py:66


# ---- shared with test_torch_grad_pt.py and test_torch_train.py ----

def port_rays(rays):
    """The JAX package's ray batch as the port's."""
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    def vec(v):
        return Vec3(*(torch.from_numpy(np.array(c, np.float32)) for c in v))
    return intersect.Rays(o=vec(rays.o), d=vec(rays.d),
                          time=torch.from_numpy(np.array(rays.time)))


def port_vec3(a):
    """An [N, 3] array as a port Vec3."""
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    a = np.asarray(a, np.float32)
    return Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))


def setup_scene(name, res, seed, zero_bg=False):
    """One scene in both packages, with the JAX package's center-of-pixel
    rays at res x res (tests/test_grad.py's ``_ray_batch``): a dict of the
    JAX scene, rays, background [N, 3] and key, and the port's."""
    from raytracer795_tpu.models import camera as jax_camera

    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy
    from raytracer795_tpu_torch.utils import rng

    loaded = conftest.load(name)
    scene = loaded.scene
    cam = dataclasses.replace(loaded.cameras[0], nx=res, ny=res,
                              num_samples=1, grid=1)
    rays = jax_camera.primary_rays(cam)
    n = rays.o.shape[0]
    bg = (jnp.zeros((n, 3), jnp.float32) if zero_bg
          else jnp.broadcast_to(jnp.asarray(scene.background, jnp.float32),
                                (n, 3)))
    return {"scene": scene, "rays": rays, "bg": bg,
            "key": jax.random.PRNGKey(seed), "n": n,
            "pscene": scene_from_numpy(
                jax.tree_util.tree_map(np.asarray, scene), "cpu"),
            "prays": port_rays(rays), "pbg": port_vec3(bg),
            "pkey": rng.PRNGKey(seed)}


def flat(tree):
    """Every tensor (or array) of a parameter dict, in its order."""
    return [x for v in tree.values()
            for x in (v if isinstance(v, tuple) else (v,))]


def leaf_params(pscene):
    """The port's ``differentiable_params`` as fresh leaves that require
    grad."""
    from raytracer795_tpu_torch.parallel import shard as par

    return {k: (tuple(x.detach().requires_grad_() for x in v)
                if isinstance(v, tuple) else v.detach().requires_grad_())
            for k, v in par.differentiable_params(pscene).items()}


def port_grads(pscene, render, loss_of_img):
    """(loss, gradients) of ``loss_of_img(render(scene))`` over the port's
    ``differentiable_params``, with the gradients in that dict's
    structure."""
    from raytracer795_tpu_torch.parallel import shard as par

    leaves = leaf_params(pscene)
    loss = loss_of_img(render(par.scene_with_params(pscene, leaves)))
    got = iter(torch.autograd.grad(loss, flat(leaves), allow_unused=True))
    grads = {}
    for k, v in leaves.items():
        def one(x):
            g = next(got)
            return torch.zeros_like(x) if g is None else g
        grads[k] = tuple(one(x) for x in v) if isinstance(v, tuple) else one(v)
    return float(loss.detach()), grads


def mse(target, n):
    """tests/test_parallel.py's loss: sum((img - target)^2) / (3 N)."""
    def loss(img):
        return torch.sum((img - torch.as_tensor(target)) ** 2) / (3.0 * n)
    return loss


def jax_mse_grads(s, render, names=None):
    """(loss, gradients) of the same MSE in the JAX package, ONE
    ``jax.jit(jax.value_and_grad)``: over every differentiable parameter,
    or over the texture images ``names`` gives the indices of."""
    from raytracer795_tpu.parallel import shard as jpar

    scene, n = s["scene"], s["n"]
    target = jnp.full((n, 3), TARGET, jnp.float32)

    def loss_of(img):
        return jnp.sum((img - target) ** 2) / (3.0 * n)

    if names is None:
        params = jpar.differentiable_params(scene)

        def loss_p(p):
            return loss_of(render(jpar.scene_with_params(scene, p)))
    else:
        params = tuple(jnp.asarray(scene.textures[i].image) for i in names)

        def loss_p(ims):
            texs = list(scene.textures)
            for i, im in zip(names, ims):
                texs[i] = dataclasses.replace(texs[i], image=im)
            return loss_of(render(dataclasses.replace(
                scene, textures=tuple(texs))))
    loss, grads = jax.jit(jax.value_and_grad(loss_p))(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def assert_grads_close(got, want, name):
    """The port's gradient family against the JAX package's."""
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in
            (want if isinstance(want, tuple) else (want,))]
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        if not w.size:
            continue
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=name)


def dir_deriv(grads, params, names):
    """d/ds at s=1 of L(params with family ``names`` scaled by s) ==
    sum over the family of <dL/dtheta, theta> (tests/test_grad.py:30)."""
    return sum(float(torch.sum(g * p)) for name in names
               for g, p in zip(flat({name: grads[name]}),
                               flat({name: params[name]})))


def scaled(params, names, s):
    out = dict(params)
    for name in names:
        p = params[name]
        out[name] = (tuple(x * s for x in p) if isinstance(p, tuple)
                     else p * s)
    return out


def fd_family(mean_loss, params, names, g, eps, rtol, atol=1e-6):
    """Central FD of the family-scale scalar against the analytic
    directional derivative ``g`` (tests/test_grad.py:48)."""
    lp = mean_loss(scaled(params, names, 1.0 + eps))
    lm = mean_loss(scaled(params, names, 1.0 - eps))
    fd = (lp - lm) / (2 * eps)
    assert np.isfinite(g) and np.isfinite(fd), (g, fd)
    assert abs(g - fd) <= rtol * max(abs(fd), abs(g)) + atol, (g, fd)


def mean_loss_fn(pscene, render):
    """params -> mean radiance of the frame, without autograd."""
    from raytracer795_tpu_torch.parallel import shard as par

    def mean_loss(params):
        with torch.no_grad():
            return float(render(par.scene_with_params(pscene, params)).mean())
    return mean_loss


# ---- Whitted ----

def _whitted(s, iters):
    from raytracer795_tpu.models import whitted as jax_whitted

    from raytracer795_tpu_torch.models import whitted

    def jax_render(sc):
        return jax_whitted.render_rays(sc, s["rays"], s["bg"], s["key"],
                                       max_iters=iters)

    def render(sc):
        return whitted.render_rays(sc, s["prays"], s["pbg"], s["pkey"],
                                   differentiable=True, max_iters=iters)
    return jax_render, render


@pytest.fixture(scope="module")
def cornell():
    """cornellbox at 24x24, key 0 (tests/test_grad.py:127-150): the
    measured trip counts, the JAX MSE gradients, and the port's MSE and
    mean-radiance gradients."""
    from raytracer795_tpu.models import whitted as jax_whitted

    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par

    s = setup_scene("cornellbox", 24, 0)
    count = jax_whitted.forward_iteration_count(s["scene"], s["rays"],
                                                s["bg"], s["key"])
    s["jax_count"] = count
    s["count"] = whitted.forward_iteration_count(s["pscene"], s["prays"],
                                                 s["pbg"], s["pkey"])
    jax_render, render = _whitted(s, count + 2)
    s["render"] = render
    s["jax_loss"], s["jax_grads"] = jax_mse_grads(s, jax_render)
    s["loss"], s["grads"] = port_grads(s["pscene"], render,
                                       mse(TARGET, s["n"]))
    _, s["mean_grads"] = port_grads(s["pscene"], render, torch.mean)
    s["params"] = par.differentiable_params(s["pscene"])
    return s


KD_DECALS = (0, 1, 4)   # DECAL_REPLACE_KD, DECAL_BLEND_KD, DECAL_REPLACE_ALL


@pytest.fixture(scope="module")
def textures():
    """textures at 32x32, key 0 (tests/test_grad.py:181-215): the JAX MSE
    gradient of the kd-decal image textures (the ones XLA:CPU can
    differentiate), the port's over every parameter."""
    from raytracer795_tpu.models import whitted as jax_whitted
    from raytracer795_tpu.scene import types as JT

    from raytracer795_tpu_torch.models import whitted

    s = setup_scene("textures", 32, 0)
    s["jax_count"] = jax_whitted.forward_iteration_count(
        s["scene"], s["rays"], s["bg"], s["key"])
    s["count"] = whitted.forward_iteration_count(s["pscene"], s["prays"],
                                                 s["pbg"], s["pkey"])
    kd = [i for i, (decal, _, ttype, _) in
          enumerate(s["scene"].texture_statics)
          if decal in KD_DECALS and ttype == JT.TEX_IMAGE]
    assert kd, "textures.xml has kd-decal image textures"
    s["kd"] = kd
    jax_render, render = _whitted(s, s["jax_count"] + 2)
    s["render"] = render
    s["jax_loss"], s["jax_grads"] = jax_mse_grads(s, jax_render, kd)
    s["loss"], s["grads"] = port_grads(s["pscene"], render,
                                       mse(TARGET, s["n"]))
    return s


@pytest.mark.parametrize("which", ["cornell", "textures"])
def test_forward_iteration_count_matches_jax(which, request):
    s = request.getfixturevalue(which)
    assert s["count"] == s["jax_count"]
    if which == "cornell":
        assert s["count"] == 15     # tests/test_grad.py:144


@pytest.mark.parametrize("which", ["cornell", "textures"])
def test_differentiable_frame_is_bit_equal(which, request):
    """The differentiable frame (graph built, iterations checkpointed)
    equals the forward frame bit for bit."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par

    s = request.getfixturevalue(which)
    ps = s["pscene"]
    want = whitted.render_rays(ps, s["prays"], s["pbg"], s["pkey"])
    got = whitted.render_rays(par.scene_with_params(ps, leaf_params(ps)),
                              s["prays"], s["pbg"], s["pkey"],
                              differentiable=True, max_iters=s["count"] + 2)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["diffuse", "specular", "mirror", "ambient",
                                  "point_intensity", "vertices"])
def test_grads_match_jax(cornell, name):
    assert abs(cornell["loss"] - cornell["jax_loss"]) <= 1e-5 * abs(
        cornell["jax_loss"])
    assert_grads_close(cornell["grads"][name], cornell["jax_grads"][name],
                       name)
    assert np.abs(np.asarray(cornell["grads"][name])).max() > 0, name


def test_texture_grads_match_jax(textures):
    got = textures["grads"]["texture_images"]
    assert_grads_close(tuple(got[i] for i in textures["kd"]),
                       tuple(textures["jax_grads"]), "texture_images")
    for g in got:
        assert torch.isfinite(g).all()
    assert all(float(got[i].abs().max()) > 0 for i in textures["kd"])


def test_diffuse_fd(cornell):
    g = dir_deriv(cornell["mean_grads"], cornell["params"], ["diffuse"])
    fd_family(mean_loss_fn(cornell["pscene"], cornell["render"]),
              cornell["params"], ["diffuse"], g, eps=1e-2, rtol=0.02)


def test_point_light_fd(cornell):
    g = dir_deriv(cornell["mean_grads"], cornell["params"],
                  ["point_intensity"])
    fd_family(mean_loss_fn(cornell["pscene"], cornell["render"]),
              cornell["params"], ["point_intensity"], g, eps=1e-2,
              rtol=0.02)
    assert g > 0


def test_per_material_grad_is_local(cornell):
    """Finite per-material diffuse rows, at least one visible material
    carrying signal (tests/test_grad.py:164-172)."""
    g = cornell["mean_grads"]["diffuse"].numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).sum(axis=1).max() > 0


def _texel_fd(pscene, render, ti, n_texels, eps, rtol):
    """The port's gradient of the mean radiance with respect to texture
    ``ti``'s image, held to central FD at its ``n_texels`` strongest texels
    (texel values are 0..255)."""
    im0 = pscene.textures[ti].image

    def with_image(im):
        texs = list(pscene.textures)
        texs[ti] = dataclasses.replace(texs[ti], image=im)
        return dataclasses.replace(pscene, textures=tuple(texs))

    leaf = im0.detach().requires_grad_()
    (g,) = torch.autograd.grad(render(with_image(leaf)).mean(), leaf)
    g = g.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "texture gradient is identically zero"
    for k in np.argsort(np.abs(g).ravel())[-n_texels:]:
        y, x, c = np.unravel_index(k, g.shape)
        losses = []
        for sign in (1, -1):
            im = im0.clone()
            im[y, x, c] += sign * eps
            with torch.no_grad():
                losses.append(float(render(with_image(im)).mean()))
        fd = (losses[0] - losses[1]) / (2 * eps)
        assert abs(g[y, x, c] - fd) <= rtol * max(abs(fd), 1e-12), \
            (int(y), int(x), int(c), g[y, x, c], fd)


def test_per_texel_fd(textures):
    """tests/test_grad.py:181-215 on the port: texture 0, 3 texels, 2%."""
    _texel_fd(textures["pscene"], textures["render"], 0, 3, eps=2.0,
              rtol=0.02)


def _port_frame_rays(name, res, **load_kw):
    """A port scene loaded from its XML with the render path's own rays
    and background at res x res, lanes in row-major pixel order: (scene,
    rays, background)."""
    from raytracer795_tpu_torch import render as port_render
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(os.path.join(conftest.SCENES, name + ".xml"), "cpu",
                    **load_kw)
    cam = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
    lane = torch.arange(res * res, dtype=torch.int32)
    px, py = lane % res, lane // res
    rays = camera.primary_rays_at(cam, px, py)
    return (ld.scene, rays,
            port_render._background_radiance(ld.scene, cam, rays, px, py))


def test_bump_texture_fd():
    """tests/test_tpu.py:143-198 on the port: the bump texture's image
    feeds the shading normal and the continuation rays; its 2 strongest
    texels at 5% (the normalize downstream is mildly nonlinear)."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.scene import types as T
    from raytracer795_tpu_torch.utils import rng

    scene, rays, bg = _port_frame_rays("textures", 24)
    key = rng.PRNGKey(0)
    iters = whitted.forward_iteration_count(scene, rays, bg, key) + 1
    bump = next(i for i, st in enumerate(scene.texture_statics)
                if st[0] == T.DECAL_BUMP_NORMAL)

    def render(sc):
        return whitted.render_rays(sc, rays, bg, key, differentiable=True,
                                   max_iters=iters)
    _texel_fd(scene, render, bump, 2, eps=2.0, rtol=0.05)


def test_vertex_fd():
    """No vertex FD exists in the JAX package's tests. ply_smooth through
    the BVH walk (``bvh_min_tris=1``), 64x64: the smooth octahedron's
    vertices move along a seeded direction; the test pixels (its hits whose
    four neighbours hit it too) keep their winning primitive at +-eps
    (asserted), both sides render with the same key (common random
    numbers), and the analytic directional derivative of their mean
    radiance matches central FD within 2%."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.utils import rng

    res = 64
    scene, rays, bg = _port_frame_rays("ply_smooth", res, bvh_min_tris=1)
    assert all(g.bvh is not None for g in scene.groups if g.n_tris)
    key = rng.PRNGKey(0)
    iters = whitted.forward_iteration_count(scene, rays, bg, key) + 2
    gi = next(i for i, g in enumerate(scene.groups)
              if g.n_tris and bool(g.tri_smooth.any()))
    moved = torch.unique(scene.groups[gi].tri_vidx.long())
    direction = torch.zeros_like(scene.vertices)
    direction[moved] = torch.from_numpy(np.random.default_rng(0).normal(
        size=(moved.shape[0], 3)).astype(np.float32))
    v0 = scene.vertices
    eps = 1e-3

    def at(verts):
        return dataclasses.replace(scene, vertices=verts)

    def hits(verts):
        with torch.no_grad():
            h = intersect.trace(at(verts), rays)
        return torch.where(h.valid & (h.group == gi), h.prim, -1)

    # the test pixels
    prim = hits(v0)
    on = (prim >= 0).reshape(res, res)
    inner = on.clone()
    inner[1:] &= on[:-1]
    inner[:-1] &= on[1:]
    inner[:, 1:] &= on[:, :-1]
    inner[:, :-1] &= on[:, 1:]
    mask = inner.reshape(-1)
    assert int(mask.sum()) >= 20, int(mask.sum())
    for sign in (1, -1):
        assert torch.equal(hits(v0 + sign * eps * direction)[mask],
                           prim[mask])

    def loss(verts):
        img = whitted.render_rays(at(verts), rays, bg, key,
                                  differentiable=True, max_iters=iters)
        return img[mask].mean()

    leaf = v0.detach().requires_grad_()
    (grad,) = torch.autograd.grad(loss(leaf), leaf)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    g = float(torch.sum(grad * direction))
    with torch.no_grad():
        fd = (float(loss(v0 + eps * direction))
              - float(loss(v0 - eps * direction))) / (2 * eps)
    assert abs(g - fd) <= 0.02 * max(abs(fd), abs(g)), (g, fd)


@pytest.mark.parametrize("packed", [False, True])
def test_tables_hold_no_graph(packed):
    """With vertices that require grad, ``build_tables`` and
    ``build_multi_tables`` make rows off the tape; a vertex moved in place
    (tests/test_pallas.py:209-style) still gives the hits of tables built
    from the moved vertices."""
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.ops import bvh_traverse as bt
    from raytracer795_tpu_torch.scene.types import to_device

    gen = np.random.default_rng(5)
    t, n = 600, 1024
    verts = gen.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    o = gen.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro, rd = port_vec3(o), port_vec3(d)
    eps = torch.tensor(1e-3)
    if packed:
        perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=128)
        packs = to_device(packs, "cpu")
        assert len(packs) > 3

        def query(v):
            mt = bt.build_multi_tables(packs, v, tv)
            return mt.tris, bt.tri_bvh_nearest_multi(mt, ro, rd, eps)
    else:
        flat_bvh, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx))
        flat_bvh = to_device(flat_bvh, "cpu")

        def query(v):
            tb = bt.build_tables(flat_bvh, v, tv)
            return tb.tris, bt.tri_bvh_nearest(tb, ro, rd, eps)
    tv = torch.from_numpy(tri_vidx[perm])
    live = torch.from_numpy(verts.copy()).requires_grad_()
    rows, before = query(live)
    assert live.requires_grad and not rows.requires_grad
    assert rows.grad_fn is None
    step = torch.from_numpy(gen.normal(scale=0.05, size=verts.shape).astype(
        np.float32))
    with torch.no_grad():
        live += step                    # an optimizer step, in place
    rows, after = query(live)
    assert not rows.requires_grad
    _, fresh = query(torch.from_numpy(verts) + step)
    for a, b in zip(after, fresh):
        assert torch.equal(a, b)
    assert not torch.equal(after[0], before[0])
    assert bool((after[0] < 1e38).any())
