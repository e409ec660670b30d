"""The port's textures, environment light and image backgrounds against
the JAX package and the reference goldens.

- Perlin noise and its gradient, bit for bit with the JAX package's on
  seeded points, and at the reference values of tests/test_units.py.
- ``sample_image`` (nearest and bilinear, uv outside [0, 1)) and
  ``sample_gradient``, bit for bit.
- ``apply_textures`` on the hits of seeded rays into textures.xml.
- The textures, background, ply_smooth and envlight goldens at the bounds
  of tests/test_golden.py, and each frame against the JAX render of the
  same scene and seed; a rock6k copy of rock100k_tex through the BVH walks.
- Textured and environment-lit scenes load with PIL unimportable.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)


def _jvec(a):
    from raytracer795_tpu.utils.vec3 import Vec3

    return Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tvec(a):
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _points(seed, n=4096):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    p[:64] = np.round(p[:64])                   # on lattice planes
    p[64:128] *= np.float32(1e-3)               # near the origin
    return p


@pytest.mark.parametrize("nc", ["linear", "absval", "none"])
def test_perlin_bits_equal_jax(nc):
    """perlin and perlin_gradient on 4,096 seeded points at three scales:
    every output bit equals the JAX package's."""
    from raytracer795_tpu.ops import perlin as jax_perlin

    from raytracer795_tpu_torch.ops import perlin
    from raytracer795_tpu_torch.scene import types as T

    code = {"linear": T.NC_LINEAR, "absval": T.NC_ABSVAL,
            "none": T.NC_NONE}[nc]
    p = _points(code)
    for scale in (np.float32(1.0), np.float32(3.0), np.float32(6.5)):
        want = jax_perlin.perlin(_jvec(p), scale, code)
        got = perlin.perlin(_tvec(p), torch.tensor(scale), code)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        gw = jax_perlin.perlin_gradient(_jvec(p), scale, code)
        gg = perlin.perlin_gradient(_tvec(p), torch.tensor(scale), code)
        for g, w in zip(gg, gw):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_perlin_meets_reference_values():
    """tests/test_units.py:43-72's values from the reference's Perlin.cpp."""
    from test_units import TestPerlin

    from raytracer795_tpu_torch.ops import perlin
    from raytracer795_tpu_torch.scene import types as T

    for pt, (lin1, abs3, none2) in TestPerlin.CASES:
        p = _tvec(np.asarray([pt], np.float32))
        assert float(perlin.perlin(p, 1.0, T.NC_LINEAR)[0]) == \
            pytest.approx(lin1, abs=2e-5)
        assert float(perlin.perlin(p, 3.0, T.NC_ABSVAL)[0]) == \
            pytest.approx(abs3, abs=2e-5)
        assert float(perlin.perlin(p, 2.0, T.NC_NONE)[0]) == \
            pytest.approx(none2, abs=2e-5)
    g = perlin.perlin_gradient(_tvec(np.asarray([(0.3, 0.7, 1.9)],
                                                np.float32)),
                               2.0, T.NC_LINEAR)
    assert np.allclose([float(c[0]) for c in g],
                       [0.482619, -0.478268, -0.570059], atol=2e-3)


def _textures(shape, seed):
    """A seeded image texture in both packages' types (nearest, bilinear)."""
    from raytracer795_tpu.scene import types as JT

    from raytracer795_tpu_torch.scene import types as T

    img = np.random.default_rng(seed).uniform(0, 255, shape + (3,)).astype(
        np.float32)
    out = []
    for interp in (T.INTERP_NN, T.INTERP_BILINEAR):
        fields = dict(normalizer=np.float32(255), bump_factor=np.float32(1),
                      noise_scale=np.float32(1), decal=T.DECAL_REPLACE_KD,
                      interp=interp, ttype=T.TEX_IMAGE, nc=T.NC_NONE)
        out.append((JT.Texture(image=jnp.asarray(img), **fields),
                    T.Texture(image=torch.from_numpy(img), **fields)))
    return out


@pytest.mark.parametrize("shape", [(64, 64), (48, 96), (1, 5)])
def test_sampling_bits_equal_jax(shape):
    """sample_image (nearest and bilinear) and sample_gradient on seeded uv
    in [-3, 3), on the texel grid, and at 0 and just below 1: bit for
    bit with the JAX package's."""
    from raytracer795_tpu.ops import texture as jax_texture

    from raytracer795_tpu_torch.ops import texture

    rng = np.random.default_rng(shape[0])
    u = rng.uniform(-3, 3, 4096).astype(np.float32)
    v = rng.uniform(-3, 3, 4096).astype(np.float32)
    u[:256] = np.arange(256, dtype=np.float32) / shape[1] - 1.0
    v[256:512] = np.arange(256, dtype=np.float32) / shape[0] - 2.0
    u[512:520] = [0.0, -0.0, 1.0, -1.0, np.nextafter(np.float32(1), 0),
                  -1e-8, 1e-8, 3.0]
    for jt, tt in _textures(shape, 7):
        want = jax_texture.sample_image(jt, jnp.asarray(u), jnp.asarray(v))
        got = texture.sample_image(tt, torch.from_numpy(u),
                                   torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        want = jax_texture.sample_gradient(jt, jnp.asarray(u),
                                           jnp.asarray(v))
        got = texture.sample_gradient(tt, torch.from_numpy(u),
                                      torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def _port_details(jd):
    """A JAX HitDetails as the port's, leaf for leaf."""
    from raytracer795_tpu_torch.ops.intersect import HitDetails
    from raytracer795_tpu_torch.utils.vec3 import Mat3, Vec3

    classes = {"Vec3": Vec3, "Mat3": Mat3, "HitDetails": HitDetails}

    def port(x):
        if isinstance(x, tuple):
            return classes[type(x).__name__](*(port(y) for y in x))
        return torch.from_numpy(np.array(x))
    return port(jd)


def test_apply_textures_matches_jax():
    """Seeded rays from the camera into textures.xml (every decal mode,
    image and Perlin, spheres and triangles), each package on its own
    load. Each package's own hits give equal hit masks and decal modes;
    on the JAX package's hit details, the port's texture color and
    normalizer equal the JAX package's and its shading normal is within
    1e-6. (The port's own sphere uv differ from the JAX package's by an
    ulp of acos/atan2 on a few lanes, which a bilinear tap of the checker
    scales up; the frame tests hold the end result.)"""
    from raytracer795_tpu.ops import intersect as jax_intersect
    from raytracer795_tpu.ops import texture as jax_texture
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.ops import intersect, texture
    from raytracer795_tpu_torch.scene.loader import load_scene

    path = os.path.join(conftest.SCENES, "textures.xml")
    js = jax_load(path).scene
    ts = load_scene(path, "cpu").scene
    n = 4096
    rng = np.random.default_rng(11)
    target = np.stack([rng.uniform(-3.2, 3.2, n), rng.uniform(-0.2, 3.6, n),
                       rng.uniform(-1.5, 0.8, n)], 1)
    o = np.broadcast_to(np.float32([0, 1.6, 6]), (n, 3)).copy()
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = np.zeros(n, np.float32)

    jr = jax_intersect.Rays(o=_jvec(o), d=_jvec(d), time=jnp.asarray(time))
    jhit = jax_intersect.trace(js, jr)
    jdet = jax_intersect.hit_details(
        js, jr, jhit, jax_intersect.compute_vertex_normals(js))
    want = jax_texture.apply_textures(js, jdet)

    tr = intersect.Rays(o=_tvec(o), d=_tvec(d), time=torch.from_numpy(time))
    thit = intersect.trace(ts, tr)
    own = texture.apply_textures(ts, intersect.hit_details(
        ts, tr, thit, intersect.compute_vertex_normals(ts)))
    valid = np.asarray(jhit.valid)
    np.testing.assert_array_equal(thit.valid.numpy(), valid)
    assert valid.mean() > 0.5
    np.testing.assert_array_equal(own.dm.numpy(), np.asarray(want.dm))
    used = (set(np.asarray(jdet.tex0)[valid])
            | set(np.asarray(jdet.tex1)[valid]))
    assert used >= set(range(7)), used

    got = texture.apply_textures(ts, _port_details(jdet))
    np.testing.assert_array_equal(got.dm.numpy(), np.asarray(want.dm))
    for g, w in ((got.tex_normalizer, want.tex_normalizer),
                 *zip(got.tex_color, want.tex_color),
                 *zip(got.normal, want.normal)):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid],
                                   rtol=0, atol=1e-6)


def _port_frame(name, res=None, path=None):
    from raytracer795_tpu_torch.render import render_camera
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(path or os.path.join(conftest.SCENES, name + ".xml"),
                    "cpu")
    if res:
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
    return render_camera(ld, 0, ldr=True).astype(np.float32)


def _jax_frame(name, res=None, path=None):
    from raytracer795_tpu.render import render_camera
    from raytracer795_tpu.scene.loader import load_scene

    jl = load_scene(path or os.path.join(conftest.SCENES, name + ".xml"))
    if res:
        jl.cameras[0] = dataclasses.replace(jl.cameras[0], nx=res, ny=res)
    return conftest.ldr(render_camera(jl, 0, seed=0))


@pytest.mark.parametrize("name,mean_tol,frac_tol", [
    ("ply_smooth", 0.2, 0.01),
    ("textures", 0.05, 0.002),
    ("background", 0.05, 0.002),
])
def test_texture_golden(name, mean_tol, frac_tol):
    """tests/test_golden.py:30-32's bounds, through the port's loader."""
    diff = np.abs(_port_frame(name) - conftest.golden(name))
    assert diff.mean() < mean_tol, f"mean {diff.mean()}"
    assert (diff > 2).mean() < frac_tol, f"frac>2 {(diff > 2).mean()}"


def test_envlight_golden():
    """tests/test_golden.py:63-81: the direct sky view tightly, 8x8-pooled
    means and the frame mean loosely (16 spp of one env sample each)."""
    img = _port_frame("envlight")
    gold = conftest.golden("envlight")
    assert np.abs(img[:40] - gold[:40]).mean() < 0.05

    def pool(a):
        return a.reshape(20, 8, 20, 8, 3).mean(axis=(1, 3))
    assert np.abs(pool(img) - pool(gold)).mean() < 6.0
    assert abs(img.mean() - gold.mean()) < 3.0


@pytest.mark.parametrize("name,bound", [
    ("textures", 1e-4), ("background", 1e-4), ("ply_smooth", 1e-4),
    # one-ulp acos/atan2/sin differences can move a hemisphere sample
    ("envlight", 1e-3),
])
def test_frame_matches_jax_render(name, bound):
    """The port's frame (its own loader) against the JAX render of the
    same scene and seed; measured: 0 values differ by more than 1."""
    got, want = _port_frame(name), _jax_frame(name)
    frac = (np.abs(got - want) > 1).mean()
    assert frac < bound, f"{frac:.6f} of LDR values differ by more than 1"


def rock6k_tex_xml(tmp_path, res=64):
    """rock100k_tex.xml with the 6,242-triangle rock6k.ply, at res x res."""
    src = open(os.path.join(conftest.SCENES, "rock100k_tex.xml")).read()
    ply = os.path.join(conftest.SCENES, "rock6k.ply")
    src = src.replace('plyFile="rock100k.ply"', f'plyFile="{ply}"')
    src = src.replace("400 400", f"{res} {res}")
    for name in ("checker.png", "bump.png", "gradient.jpg"):
        src = src.replace(f">{name}<",
                          f">{os.path.join(conftest.SCENES, name)}<")
    path = os.path.join(str(tmp_path), "rock6k_tex.xml")
    with open(path, "w") as f:
        f.write(src)
    return path


def test_rock6k_tex_frame_matches_jax_render(tmp_path):
    """rock100k_tex's textures over rock6k at 64x64 through the BVH walks
    (Perlin color and bump on the rock, image color and bump on the
    mirror floor, the JPEG background), against the JAX render."""
    from raytracer795_tpu_torch.scene.loader import load_scene

    path = rock6k_tex_xml(tmp_path)
    scene = load_scene(path, "cpu").scene
    (group,) = scene.groups
    assert group.bvh is not None and scene.bg_texture == 4
    got, want = _port_frame(None, path=path), _jax_frame(None, path=path)
    frac = (np.abs(got - want) > 1).mean()
    assert frac < 1e-4, f"{frac:.6f} of LDR values differ by more than 1"
    assert got.std() > 10


@pytest.mark.parametrize("name", ["textures", "envlight"])
def test_scenes_load_without_pil(name, monkeypatch):
    """PNG, JPEG and EXR textures load with PIL unimportable, to the bytes
    the JAX loader's PIL gives."""
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.loader import load_scene

    path = os.path.join(conftest.SCENES, name + ".xml")
    want = [np.asarray(t.image) for t in jax_load(path).scene.textures]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    scene = load_scene(path, "cpu").scene
    assert len(scene.textures) == len(want)
    for tex, w in zip(scene.textures, want):
        np.testing.assert_array_equal(tex.image.numpy(), w)
