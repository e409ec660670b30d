"""The port's lane split over a mesh: sharded renders and train steps
(ports of tests/test_parallel.py:43-126).

A mesh is a list of devices, and one device may stand in it several times:
here ``[cpu] * k``, so the split, the per-shard keys and the all-reduce run
as they do over several cards.
- cornellbox at 16x16 (Whitted, draws no random numbers) over 1, 2 and 8
  shards equals ``whitted.render_rays`` bit for bit;
- cornellbox_pt (depth 3) at 16x16 over 4 shards matches the JAX package's
  ``render_rays_sharded(..., make_ray_mesh(4))`` at
  tests/test_torch_path_tracer.py's frame rule: 98% of values within
  rtol 1e-4, atol 1e-3, the mean within 0.5%. Each shard draws from
  ``fold_in(key, i)``, as there;
- the 4-shard ``train_step_with_grads`` equals the one-shard step at
  rtol 2e-3, atol 2e-3 max|g|; ``mesh=None`` is the one-device step's
  formula bit for bit; three 4-shard steps with tests/test_parallel.py's
  rates descend with every gradient finite.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_grad import (TARGET, flat, leaf_params, port_rays, port_vec3,
                             setup_scene)
from test_torch_path_tracer import assert_frames_agree, variant

torch.set_num_threads(1)

CPU = torch.device("cpu")
LRS = {"diffuse": 1e-4, "specular": 1e-4, "ambient": 1e-4, "mirror": 1e-4,
       "point_intensity": 1e-1}
GRAD_FAMILIES = ("diffuse", "mirror", "point_intensity", "vertices")


@pytest.fixture(scope="module")
def cornell():
    """cornellbox at 16x16 with key 3 (tests/test_parallel.py's setup) in
    the port, through the JAX loader's scene."""
    return setup_scene("cornellbox", 16, 3)


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_render_equals_unsharded(cornell, shards):
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par

    sc, rays, bg, key = (cornell[k] for k in ("pscene", "prays", "pbg",
                                              "pkey"))
    want = whitted.render_rays(sc, rays, bg, key)
    got = par.render_rays_sharded(sc, rays, bg, key, [CPU] * shards)
    assert got.shape == (256, 3) and got.max() > 0
    assert torch.equal(got, want)


def test_shard_rays_block_split(cornell):
    from raytracer795_tpu_torch.parallel import shard as par

    rays = cornell["prays"]
    parts = par.shard_rays(rays, ["cpu"] * 4)
    assert [p.time.shape[0] for p in parts] == [64] * 4
    for i, p in enumerate(parts):
        assert torch.equal(p.d.y, rays.d.y[64 * i:64 * (i + 1)])
    with pytest.raises(ValueError, match="pad the lanes"):
        par.shard_rays(rays, [CPU] * 3)


def test_make_ray_mesh_wants_cuda(monkeypatch):
    from raytracer795_tpu_torch.parallel import shard as par

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        par.make_ray_mesh()


def test_path_traced_shards_match_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from raytracer795_tpu.models import camera as jax_camera
    from raytracer795_tpu.parallel import shard as jpar
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.parallel import shard as par
    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy
    from raytracer795_tpu_torch.utils import rng

    jl = jax_load(variant(tmp_path, "cornellbox_pt", depth=3))
    cam = dataclasses.replace(jl.cameras[0], nx=16, ny=16, num_samples=1,
                              grid=1)
    rays = jax_camera.primary_rays(cam)
    bg = jnp.broadcast_to(jnp.asarray(jl.scene.background, jnp.float32),
                          (rays.o.shape[0], 3))
    want = np.asarray(jpar.render_rays_sharded(
        jl.scene, rays, bg, jax.random.PRNGKey(3), jpar.make_ray_mesh(4)))
    pscene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jl.scene),
                              "cpu")
    got = par.render_rays_sharded(pscene, port_rays(rays), port_vec3(bg),
                                  rng.PRNGKey(3), [CPU] * 4).numpy()
    assert got.mean() > 0
    assert_frames_agree(got, want)
    # the per-shard keys matter: one shard draws other numbers
    one = par.render_rays_sharded(pscene, port_rays(rays), port_vec3(bg),
                                  rng.PRNGKey(3), [CPU]).numpy()
    assert not np.array_equal(one, got)


@pytest.fixture(scope="module")
def steps(cornell):
    """The one-shard and 4-shard train steps toward TARGET."""
    from raytracer795_tpu_torch.parallel import shard as par

    target = torch.full((cornell["n"], 3), TARGET)
    args = (cornell["pscene"], cornell["prays"], cornell["pbg"], target,
            cornell["pkey"])
    return (par.train_step_with_grads(*args, mesh=[CPU]),
            par.train_step_with_grads(*args, mesh=[CPU] * 4))


@pytest.mark.parametrize("name", GRAD_FAMILIES)
def test_sharded_grads_match_one_shard(steps, name):
    (loss1, g1, _), (loss4, g4, _) = steps
    assert abs(float(loss4) - float(loss1)) <= 1e-5 * float(loss1)
    want, got = g1[name], g4[name]
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max()) + 1e-8
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3 * scale)


def test_mesh_none_is_the_one_device_step(cornell):
    """``mesh=None``: the loss and gradients of sum((img - target)^2) / (3N)
    rendered with key fold_in(key, 0), bit for bit."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par
    from raytracer795_tpu_torch.utils import rng

    sc, rays, bg, key = (cornell[k] for k in ("pscene", "prays", "pbg",
                                              "pkey"))
    target = torch.full((cornell["n"], 3), TARGET)
    iters = par.resolve_whitted_iters(sc, rays, bg, key)
    loss, grads, _ = par.train_step_with_grads(sc, rays, bg, target, key,
                                               whitted_iters=iters)
    leaves = leaf_params(sc)
    img = whitted.render_rays(par.scene_with_params(sc, leaves), rays, bg,
                              rng.fold_in(key, 0), differentiable=True,
                              max_iters=iters)
    want = torch.sum((img - target) ** 2) / (3.0 * cornell["n"])
    got = torch.autograd.grad(want, flat(leaves), allow_unused=True)
    assert torch.equal(loss, want.detach())
    for g, w in zip(flat(grads), got):
        assert torch.equal(g, torch.zeros_like(g) if w is None else w)


def test_sharded_steps_descend(cornell):
    from raytracer795_tpu_torch.parallel import shard as par

    sc, rays, bg, key = (cornell[k] for k in ("pscene", "prays", "pbg",
                                              "pkey"))
    mesh = [CPU] * 4
    target = 0.9 * par.render_rays_sharded(sc, rays, bg, key, mesh)
    losses, cur = [], sc
    for step in range(3):
        loss, grads, cur = par.train_step_with_grads(cur, rays, bg, target,
                                                     key, lr=LRS, mesh=mesh)
        losses.append(float(loss))
        assert all(bool(torch.isfinite(g).all()) for g in flat(grads)), step
        assert all(bool(torch.isfinite(p).all())
                   for p in flat(par.differentiable_params(cur))), step
    assert losses[-1] < losses[0], losses
