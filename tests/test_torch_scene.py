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
    ("instances", 2), ("rock6k", 1024)])
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


def test_instances_share_one_bvh():
    """Instances of a base mesh share the base mesh's FlatBVH tensors."""
    from raytracer795_tpu_torch.scene.loader import load_scene

    scene = load_scene(os.path.join(conftest.SCENES, "instances.xml"),
                       "cpu", bvh_min_tris=2).scene
    inst = [g for g in scene.groups if g.name.startswith("instance#")]
    assert len(inst) >= 2
    assert all(g.bvh is inst[0].bvh for g in inst)


def test_port_never_imports_jax(tmp_path):
    """Rendering through the port leaves jax and the JAX package unloaded."""
    code = f"""
import sys
import numpy as np
import raytracer795_tpu_torch as rt
from raytracer795_tpu_torch import render
ld = rt.load_scene({os.path.join(conftest.SCENES, 'simple.xml')!r}, "cpu")
ld.cameras[0].nx = ld.cameras[0].ny = 16
img = render.render_camera(ld, 0, ldr=True)
assert img.shape == (16, 16, 3) and img.max() > 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "raytracer795_tpu")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_texture_and_env_scenes_raise():
    """Features outside the slice raise NotImplementedError, not render."""
    from raytracer795_tpu_torch.render import render_camera
    from raytracer795_tpu_torch.scene.loader import load_scene

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_scene(os.path.join(conftest.SCENES, "envlight.xml"), "cpu")
    ld = load_scene(os.path.join(conftest.SCENES, "textures.xml"), "cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        render_camera(ld, 0)
