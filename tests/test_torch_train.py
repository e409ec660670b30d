"""The port's one-device inverse-rendering train step (parallel/shard.py).

- On cornellbox at 16x16 with PRNGKey(3) (tests/test_parallel.py's setup),
  ``train_step_with_grads`` equals the JAX package's
  ``train_step_with_grads(..., make_ray_mesh(1))``: the loss, every
  gradient family at rtol=2e-3, atol=2e-3 * max|g_jax|, and the updated
  parameters.
- Three steps toward 0.9 x the scene's own frame with
  tests/test_parallel.py:112-113's per-parameter rates descend, every
  gradient and parameter finite (tests/test_parallel.py:99-126); the
  caller's scene is left as it was, and none of its tensors requires grad
  or holds a ``.grad``.
- A scalar rate moves every parameter by ``lr * grad``; the path tracer's
  step measures no trip count and gives finite gradients.
"""

import numpy as np
import pytest
import torch

from test_torch_grad import (TARGET, assert_grads_close, flat, port_vec3,
                             setup_scene)

torch.set_num_threads(1)

LRS = {"diffuse": 1e-4, "specular": 1e-4, "ambient": 1e-4, "mirror": 1e-4,
       "point_intensity": 1e-1}


@pytest.fixture(scope="module")
def cornell():
    """cornellbox at 16x16; the JAX package's one-device train step."""
    from raytracer795_tpu.parallel import shard as jpar

    s = setup_scene("cornellbox", 16, 3)
    target = np.full((s["n"], 3), TARGET, np.float32)
    loss, grads, new_scene = jpar.train_step_with_grads(
        s["scene"], s["rays"], s["bg"], target, s["key"],
        jpar.make_ray_mesh(1))
    s["target"] = target
    s["jax_loss"] = float(loss)
    s["jax_grads"] = {k: (tuple(np.asarray(x) for x in v)
                          if isinstance(v, tuple) else np.asarray(v))
                      for k, v in grads.items()}
    s["jax_new"] = {k: (tuple(np.asarray(x) for x in v)
                        if isinstance(v, tuple) else np.asarray(v))
                    for k, v in jpar.differentiable_params(new_scene).items()}
    return s


@pytest.fixture(scope="module")
def port_step(cornell):
    from raytracer795_tpu_torch.parallel import shard as par

    return par.train_step_with_grads(
        cornell["pscene"], cornell["prays"], cornell["pbg"],
        torch.from_numpy(cornell["target"]), cornell["pkey"])


def test_train_step_loss_matches_jax(cornell, port_step):
    loss, _, _ = port_step
    assert not loss.requires_grad
    assert abs(float(loss) - cornell["jax_loss"]) <= 1e-5 * cornell["jax_loss"]


@pytest.mark.parametrize("name", ["diffuse", "specular", "mirror", "ambient",
                                  "point_intensity", "dir_radiance",
                                  "spot_intensity", "area_radiance",
                                  "mesh_light_radiance",
                                  "sphere_light_radiance", "vertices",
                                  "texture_images"])
def test_train_step_grads_and_update_match_jax(cornell, port_step, name):
    from raytracer795_tpu_torch.parallel import shard as par

    _, grads, new_scene = port_step
    assert_grads_close(grads[name], cornell["jax_grads"][name], name)
    assert_grads_close(par.differentiable_params(new_scene)[name],
                       cornell["jax_new"][name], name)


def _frame(scene, s):
    from raytracer795_tpu_torch.models import whitted

    return whitted.render_rays(scene, s["prays"], s["pbg"], s["pkey"])


def test_three_steps_descend_and_leave_the_scene(cornell):
    from raytracer795_tpu_torch.parallel import shard as par

    scene = cornell["pscene"]
    before = [p.clone() for p in flat(par.differentiable_params(scene))]
    target = 0.9 * _frame(scene, cornell)
    losses, cur = [], scene
    for step in range(3):
        loss, grads, cur = par.train_step_with_grads(
            cur, cornell["prays"], cornell["pbg"], target, cornell["pkey"],
            lr=LRS)
        losses.append(float(loss))
        for name, g in grads.items():
            for leaf in flat({name: g}):
                assert torch.isfinite(leaf).all(), (step, name)
        for p in flat(par.differentiable_params(cur)):
            assert torch.isfinite(p).all() and not p.requires_grad
        # names the rate dict lacks do not move
        assert torch.equal(cur.vertices, scene.vertices)
    assert losses[-1] < losses[0], losses
    for p, b in zip(flat(par.differentiable_params(scene)), before):
        assert torch.equal(p, b)
        assert not p.requires_grad and p.grad is None


def test_scalar_rate_moves_every_parameter(cornell, port_step):
    from raytracer795_tpu_torch.parallel import shard as par

    _, grads, new_scene = port_step
    old = flat(par.differentiable_params(cornell["pscene"]))
    new = flat(par.differentiable_params(new_scene))
    for p, g, q in zip(old, flat(grads), new):
        assert torch.equal(q, p - 1e-2 * g)
    loss, scene2 = par.train_step(cornell["pscene"], cornell["prays"],
                                  cornell["pbg"],
                                  torch.from_numpy(cornell["target"]),
                                  cornell["pkey"])
    assert float(loss) == float(port_step[0])
    for q, q2 in zip(new, flat(par.differentiable_params(scene2))):
        assert torch.equal(q, q2)


def test_path_tracer_step():
    """cornellbox_pt at 16x16: no trip count to measure, finite gradients,
    nonzero for the walls' albedo, the mesh light and the vertices."""
    from raytracer795_tpu_torch.parallel import shard as par

    s = setup_scene("cornellbox_pt", 16, 7, zero_bg=True)
    ps = s["pscene"]
    assert par.resolve_whitted_iters(ps, s["prays"], s["pbg"],
                                     s["pkey"]) is None
    target = port_vec3(np.full((s["n"], 3), TARGET, np.float32))
    loss, grads, _ = par.train_step_with_grads(
        ps, s["prays"], s["pbg"], torch.stack(list(target), dim=-1),
        s["pkey"])
    assert np.isfinite(float(loss))
    for g in flat(grads):
        assert torch.isfinite(g).all()
    for name in ("diffuse", "mesh_light_radiance", "vertices"):
        assert max(float(g.abs().max()) for g in flat({name: grads[name]})) > 0
