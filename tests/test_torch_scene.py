"""The port's scene loader against the JAX package's.

Both packages load the same XML; the JAX scene is carried across with
``scene_from_numpy`` and every leaf must be identical, FlatBVH and
primitive order included. A subprocess proves the port never imports jax.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rock6k_xml(tmp_path, res=64):
    """rock100k.xml with the 6,242-triangle rock6k.ply, at res x res."""
    src = open(os.path.join(conftest.SCENES, "rock100k.xml")).read()
    ply = os.path.join(conftest.SCENES, "rock6k.ply")
    src = src.replace('plyFile="rock100k.ply"', f'plyFile="{ply}"')
    src = src.replace("400 400", f"{res} {res}")
    path = os.path.join(str(tmp_path), "rock6k.xml")
    with open(path, "w") as f:
        f.write(src)
    return path


def scene_path(name, tmp_path):
    if name == "rock6k":
        return rock6k_xml(tmp_path)
    return os.path.join(conftest.SCENES, name + ".xml")


def assert_same(a, b, path="scene"):
    """Recursive equality of two port scene structures."""
    assert type(a) is type(b), path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name,bvh_min_tris", [
    ("simple", 1024), ("cornellbox", 1024), ("brdfs", 1024),
    ("lights", 1024), ("transforms", 1024), ("instances", 1024),
    ("instances", 2), ("rock6k", 1024), ("cornellbox_pt", 1024),
    ("furnace", 1024), ("arealight", 1024), ("motionblur", 1024),
    ("distributed", 1024), ("rock100k_pt", 1024), ("textures", 1024),
    ("background", 1024), ("ply_smooth", 1024), ("envlight", 1024)])
def test_loader_matches_jax_loader(name, bvh_min_tris, tmp_path):
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy
    from raytracer795_tpu_torch.scene.loader import load_scene

    path = scene_path(name, tmp_path)
    ref = jax_load(path, bvh_min_tris=bvh_min_tris)
    port = load_scene(path, "cpu", bvh_min_tris=bvh_min_tris)
    bridged = scene_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.scene), "cpu")
    assert_same(port.scene, bridged)
    for cj, cp in zip(ref.cameras, port.cameras):
        for f in dataclasses.fields(cp):
            np.testing.assert_array_equal(getattr(cj, f.name),
                                          getattr(cp, f.name))
    if name == "rock6k":
        # the rock and the floor merge into one BVH group
        (g,) = port.scene.groups
        assert g.n_tris == 6242 and g.bvh is not None
    if name in ("cornellbox_pt", "furnace", "rock100k_pt"):
        # object lights and the path tracer's switches are among the leaves
        sc = port.scene
        assert sc.renderer == "pathtracing" and sc.pt_nee and sc.pt_importance
        assert sc.pt_rr == (name == "rock100k_pt")
        assert len(sc.sphere_lights) + len(sc.mesh_lights) == 1
    if name == "envlight":
        # the env light wraps its own bilinear texture of sky.exr
        sc = port.scene
        assert sc.env_texture == 0 and sc.textures[0].image.shape == \
            (64, 128, 3)


def test_instances_share_one_bvh():
    """Instances of a base mesh share the base mesh's FlatBVH tensors."""
    from raytracer795_tpu_torch.scene.loader import load_scene

    scene = load_scene(os.path.join(conftest.SCENES, "instances.xml"),
                       "cpu", bvh_min_tris=2).scene
    inst = [g for g in scene.groups if g.name.startswith("instance#")]
    assert len(inst) >= 2
    assert all(g.bvh is inst[0].bvh for g in inst)


def test_port_never_imports_jax(tmp_path):
    """Rendering through the port leaves jax, the JAX package and PIL
    unloaded, for a brute-force scene, a multi-packed rock6k, multi-sample
    frames of the path tracer and of a depth-of-field, glossy scene (the
    RNG, sample rays and path tracer modules), the textured scene with its
    PNG and JPEG images, the EXR environment light, a train step, and a
    render sharded over a two-device mesh with the tonemap, EXR and
    distributed modules imported, a net-ray count, and the profiler's
    stages with the two bench modules imported."""
    code = f"""
import sys
import numpy as np
import raytracer795_tpu_torch as rt
from raytracer795_tpu_torch import render
ld = rt.load_scene({os.path.join(conftest.SCENES, 'simple.xml')!r}, "cpu")
ld.cameras[0].nx = ld.cameras[0].ny = 16
img = render.render_camera(ld, 0, ldr=True)
assert img.shape == (16, 16, 3) and img.max() > 0
ld = rt.load_scene({rock6k_xml(tmp_path, 16)!r}, "cpu",
                   single_pack_max=2000, pack_tris=2048)
assert ld.scene.groups[0].bvh is None
assert len(ld.scene.groups[0].pack_bvhs) == 4
img = render.render_camera(ld, 0, ldr=True)
assert img.shape == (16, 16, 3) and img.max() > 0
for name in ("cornellbox_pt", "distributed"):     # path tracer; DoF, glossy
    ld = rt.load_scene({conftest.SCENES!r} + "/" + name + ".xml", "cpu")
    ld.cameras[0].nx = ld.cameras[0].ny = 8
    img = render.render_camera(ld, 0, seed=1, spp=2)
    assert img.shape == (8, 8, 3) and img.max() > 0
for name in ("textures", "envlight"):          # images; env light, spp 16
    ld = rt.load_scene({conftest.SCENES!r} + "/" + name + ".xml", "cpu")
    ld.cameras[0].nx = ld.cameras[0].ny = 8
    img = render.render_camera(ld, 0, ldr=True)
    assert img.shape == (8, 8, 3) and img.max() > 0
import torch                                      # a train step
from raytracer795_tpu_torch.models import camera
from raytracer795_tpu_torch.parallel import shard
ld = rt.load_scene({conftest.SCENES!r} + "/cornellbox.xml", "cpu")
cam = ld.cameras[0]
cam.nx = cam.ny = 8
px, py = camera.band_pixels(8, 8, "cpu")
rays = camera.primary_rays_at(cam, px, py)
bg = render._background_radiance(ld.scene, cam, rays, px, py)
loss, grads, _ = shard.train_step_with_grads(
    ld.scene, rays, bg, torch.zeros((64, 3)), (0, 0))
assert bool(torch.isfinite(grads["vertices"]).all()) and float(loss) > 0
from raytracer795_tpu_torch.parallel import distributed   # scale-out
from raytracer795_tpu_torch.utils import exr, tonemap
img = shard.render_rays_sharded(ld.scene, rays, bg, (0, 0),
                                [torch.device("cpu")] * 2)
assert img.shape == (64, 3) and float(img.max()) > 0
exr.write_exr("frame.exr", tonemap.reinhard_global(
    img.reshape(8, 8, 3).numpy()))
assert exr.read_exr("frame.exr").shape == (8, 8, 3)
from raytracer795_tpu_torch import bench, bench_mesh, profiling  # stats
assert render.count_net_rays(ld, 0) >= 64
assert [s for s, _, _ in profiling.profile_scene(ld, 8, 1)] == list(
    profiling.STAGES)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "raytracer795_tpu", "PIL")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
