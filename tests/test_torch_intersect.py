"""trace / trace_anyhit / hit_details: the port against the JAX package.

Both packages get the same scene (the JAX loader's, carried across with
``scene_from_numpy``) and the same 4096 random rays, with exact-zero
direction components among them. Validity, group and prim must be equal;
t within rtol 1e-5, atol 1e-6 (tests/test_bvh.py:62-63); the HitDetails
point and normal within 1e-5. rock6k's 6,242 triangles form one BVH group,
so there the port runs its plain BVH walks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest
from test_torch_scene import rock6k_xml

torch.set_num_threads(1)


def _rays(n, seed, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 8, 0] = 0.0
    d[n // 8: n // 4, 2] = 0.0
    cap = rng.uniform(0.1, 4.0, n).astype(np.float32)
    return o, d, cap


@pytest.mark.parametrize("name", ["cornellbox", "instances", "transforms",
                                  "rock6k"])
def test_trace_and_details_match_jax(name, tmp_path):
    from raytracer795_tpu.ops import intersect as jint
    from raytracer795_tpu.scene.loader import load_scene as jax_load
    from raytracer795_tpu.utils.vec3 import Vec3 as JV

    from raytracer795_tpu_torch.ops import intersect as tint
    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy
    from raytracer795_tpu_torch.utils.vec3 import Vec3 as TV

    path = (rock6k_xml(tmp_path) if name == "rock6k"
            else os.path.join(conftest.SCENES, name + ".xml"))
    jscene = jax_load(path).scene
    tscene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene),
                              "cpu")
    assert (name == "rock6k") == any(g.bvh is not None
                                     for g in tscene.groups)
    o, d, cap = _rays(4096, 0)
    n = o.shape[0]

    jrays = jint.Rays(o=JV.from_array(jnp.asarray(o)),
                      d=JV.from_array(jnp.asarray(d)), time=jnp.zeros(n))
    jhit = jax.jit(jint.trace)(jscene, jrays)
    jfound = jax.jit(jint.trace_anyhit)(jscene, jrays, jnp.asarray(cap))
    jdet = jax.jit(jint.hit_details)(jscene, jrays, jhit,
                                     jint.compute_vertex_normals(jscene))

    trays = tint.Rays(o=TV.from_array(torch.from_numpy(o)),
                      d=TV.from_array(torch.from_numpy(d)),
                      time=torch.zeros(n))
    thit = tint.trace(tscene, trays)
    tfound = tint.trace_anyhit(tscene, trays, torch.from_numpy(cap))
    tdet = tint.hit_details(tscene, trays, thit,
                            tint.compute_vertex_normals(tscene))

    valid = np.asarray(jhit.valid)
    assert valid.mean() > 0.05
    np.testing.assert_array_equal(thit.valid.numpy(), valid)
    for field in ("group", "prim", "is_sphere"):
        np.testing.assert_array_equal(getattr(thit, field).numpy()[valid],
                                      np.asarray(getattr(jhit, field))[valid])
    np.testing.assert_allclose(thit.t.numpy()[valid],
                               np.asarray(jhit.t)[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert 0 < np.asarray(jfound).mean() < 1
    for field in ("point", "normal"):
        got = np.stack([c.numpy() for c in getattr(tdet, field)], -1)
        want = np.stack([np.asarray(c) for c in getattr(jdet, field)], -1)
        np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tdet.mat.numpy()[valid],
                                  np.asarray(jdet.mat)[valid])
