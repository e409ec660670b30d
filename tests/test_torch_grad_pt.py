"""Pixel gradients of the port's path tracer, against the JAX package.

cornellbox_pt (NEE, cosine importance sampling, depth 6) at 24x24 with
PRNGKey(7), as tests/test_grad.py:76-124 sets it up:
- with autograd on, the frame equals the one rendered without it, bit for
  bit;
- gradients of one MSE loss against a fixed target equal ``jax.grad`` of
  the same loss (one ``jax.jit(jax.value_and_grad)``) for diffuse, mirror,
  mesh_light_radiance, sphere_light_radiance (the scene has none: the
  family is empty in both) and vertices, at rtol=2e-3, atol=2e-3 *
  max|g_jax|;
- the finite-difference checks of tests/test_grad.py on the port, with
  common random numbers (the same key on both sides): diffuse and light
  radiance at 3%, the light-part identity at 5%, mirror at 5%, and finite,
  nonzero vertex gradients.
"""

import numpy as np
import pytest
import torch

from test_torch_grad import (TARGET, assert_grads_close, dir_deriv,
                             fd_family, jax_mse_grads, leaf_params,
                             mean_loss_fn, mse, port_grads, scaled,
                             setup_scene)

torch.set_num_threads(1)

LIGHTS = ["mesh_light_radiance", "sphere_light_radiance"]


@pytest.fixture(scope="module")
def pt():
    from raytracer795_tpu.models import path_tracer as jax_pt

    from raytracer795_tpu_torch.models import path_tracer
    from raytracer795_tpu_torch.parallel import shard as par

    s = setup_scene("cornellbox_pt", 24, 7, zero_bg=True)
    assert s["pscene"].renderer == "pathtracing" and s["pscene"].pt_nee

    def render(sc):
        return path_tracer.render_rays(sc, s["prays"], s["pbg"], s["pkey"])
    s["render"] = render
    s["jax_loss"], s["jax_grads"] = jax_mse_grads(
        s, lambda sc: jax_pt.render_rays(sc, s["rays"], s["bg"], s["key"]))
    s["loss"], s["grads"] = port_grads(s["pscene"], render,
                                       mse(TARGET, s["n"]))
    _, s["mean_grads"] = port_grads(s["pscene"], render, torch.mean)
    s["params"] = par.differentiable_params(s["pscene"])
    return s


def test_differentiable_frame_is_bit_equal(pt):
    from raytracer795_tpu_torch.parallel import shard as par

    with torch.no_grad():
        want = pt["render"](pt["pscene"])
    got = pt["render"](par.scene_with_params(pt["pscene"],
                                             leaf_params(pt["pscene"])))
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["diffuse", "mirror", "mesh_light_radiance",
                                  "sphere_light_radiance", "vertices"])
def test_grads_match_jax(pt, name):
    assert abs(pt["loss"] - pt["jax_loss"]) <= 1e-5 * abs(pt["jax_loss"])
    assert_grads_close(pt["grads"][name], pt["jax_grads"][name], name)


def test_diffuse_albedo_fd(pt):
    g = dir_deriv(pt["mean_grads"], pt["params"], ["diffuse"])
    fd_family(mean_loss_fn(pt["pscene"], pt["render"]), pt["params"],
              ["diffuse"], g, eps=1e-2, rtol=0.03)
    assert g > 0    # brighter walls, brighter image


def test_light_radiance_fd(pt):
    mean_loss = mean_loss_fn(pt["pscene"], pt["render"])
    g = dir_deriv(pt["mean_grads"], pt["params"], LIGHTS)
    fd_family(mean_loss, pt["params"], LIGHTS, g, eps=1e-2, rtol=0.03)
    assert g > 0
    # emission is linear in radiance, so g is the light-dependent part of
    # the image, loss(1) - loss(0) (tests/test_grad.py:105-110)
    light_part = (mean_loss(scaled(pt["params"], LIGHTS, 1.0))
                  - mean_loss(scaled(pt["params"], LIGHTS, 0.0)))
    assert abs(g - light_part) < 0.05 * abs(g)


def test_mirror_reflectance_fd(pt):
    g = dir_deriv(pt["mean_grads"], pt["params"], ["mirror"])
    fd_family(mean_loss_fn(pt["pscene"], pt["render"]), pt["params"],
              ["mirror"], g, eps=1e-2, rtol=0.05)


def test_vertex_grads_finite_and_nonzero(pt):
    """Vertex gradients flow through the implicit hit point; an FD at a
    silhouette is not valid, so the structure is asserted
    (tests/test_grad.py:117-124)."""
    g = pt["mean_grads"]["vertices"].numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0
