"""Differentiable scene parameters and the inverse-rendering train step.

Counterpart of the training half of ``raytracer795_tpu/parallel/shard.py``,
on the scene's one device. The JAX package shards the lanes over a device
mesh and all-reduces the gradients with one ``psum``; here one device
renders every lane, and the lane split and the all-reduce across devices
are still to be ported (ROADMAP queue 1 item 18), so no function takes a
mesh. A step's loss and gradients are the JAX package's
``train_step_with_grads`` on a one-device mesh: the key folded with the
device index 0, the loss ``sum((img - target)^2) / (3 N)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from raytracer795_tpu_torch.models import path_tracer, whitted
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils import rng
from raytracer795_tpu_torch.utils.vec3 import Vec3

Params = Dict[str, Any]


def differentiable_params(scene: T.Scene) -> Params:
    """The scene leaves an optimizer moves: material tables, light powers
    and radiances, vertices and texture images (each a tensor, or a tuple
    of tensors a light or texture). They are the scene's own tensors."""
    return {
        "diffuse": scene.materials.diffuse,
        "specular": scene.materials.specular,
        "mirror": scene.materials.mirror,
        "ambient": scene.materials.ambient,
        "point_intensity": scene.lights.point_intensity,
        "dir_radiance": scene.lights.dir_radiance,
        "spot_intensity": scene.lights.spot_intensity,
        "area_radiance": scene.lights.area_radiance,
        "mesh_light_radiance": tuple(ml.radiance for ml in scene.mesh_lights),
        "sphere_light_radiance": tuple(sl.radiance
                                       for sl in scene.sphere_lights),
        "vertices": scene.vertices,
        "texture_images": tuple(t.image for t in scene.textures),
    }


def scene_with_params(scene: T.Scene, params: Params) -> T.Scene:
    """A new scene with ``params`` (``differentiable_params``' structure)
    in place of its trainable leaves; ``scene`` is left as it was."""
    mats = dataclasses.replace(
        scene.materials, diffuse=params["diffuse"],
        specular=params["specular"], mirror=params["mirror"],
        ambient=params["ambient"])
    lights = dataclasses.replace(
        scene.lights, point_intensity=params["point_intensity"],
        dir_radiance=params["dir_radiance"],
        spot_intensity=params["spot_intensity"],
        area_radiance=params["area_radiance"])
    textures = tuple(
        dataclasses.replace(t, image=im)
        for t, im in zip(scene.textures, params["texture_images"]))
    mesh_lights = tuple(
        dataclasses.replace(ml, radiance=r)
        for ml, r in zip(scene.mesh_lights, params["mesh_light_radiance"]))
    sphere_lights = tuple(
        dataclasses.replace(sl, radiance=r)
        for sl, r in zip(scene.sphere_lights, params["sphere_light_radiance"]))
    return dataclasses.replace(
        scene, materials=mats, lights=lights, mesh_lights=mesh_lights,
        sphere_lights=sphere_lights, vertices=params["vertices"],
        textures=textures)


def resolve_whitted_iters(scene: T.Scene, rays: intersect.Rays,
                          bg_radiance: Vec3, key: rng.Key,
                          margin: int = 2) -> int | None:
    """The Whitted trip count of a differentiable render: the measured
    forward count plus ``margin`` (None for the path tracer). The margin
    absorbs ray-tree changes under the small perturbations gradients and
    finite differences probe."""
    if scene.renderer == "pathtracing":
        return None
    return whitted.forward_iteration_count(scene, rays, bg_radiance,
                                           key) + margin


def _integrator(scene: T.Scene, whitted_iters: int | None) -> Callable:
    if scene.renderer == "pathtracing":
        return path_tracer.render_rays

    def render(sc, rays, bg, key):
        return whitted.render_rays(sc, rays, bg, key, differentiable=True,
                                   max_iters=whitted_iters)
    return render


def _flat(params: Params) -> list:
    """Every tensor of a parameter dict, in its order."""
    return [x for p in params.values()
            for x in (p if isinstance(p, tuple) else (p,))]


def _unflat(params: Params, leaves) -> Params:
    """``leaves`` (as ``_flat`` orders them) in ``params``' structure."""
    it = iter(leaves)
    return {name: (tuple(next(it) for _ in p) if isinstance(p, tuple)
                   else next(it)) for name, p in params.items()}


def train_step(scene: T.Scene, rays: intersect.Rays, bg_radiance: Vec3,
               target: torch.Tensor, key: rng.Key, lr=1e-2,
               whitted_iters: int | None = None
               ) -> Tuple[torch.Tensor, T.Scene]:
    """One inverse-rendering step; returns (loss, new scene)."""
    loss, _, new_scene = train_step_with_grads(scene, rays, bg_radiance,
                                               target, key, lr, whitted_iters)
    return loss, new_scene


def train_step_with_grads(scene: T.Scene, rays: intersect.Rays,
                          bg_radiance: Vec3, target: torch.Tensor,
                          key: rng.Key, lr=1e-2,
                          whitted_iters: int | None = None
                          ) -> Tuple[torch.Tensor, Params, T.Scene]:
    """One inverse-rendering step: render, MSE against ``target`` [N, 3],
    gradients of every differentiable parameter, one SGD update.

    ``lr`` is a scalar or a {parameter name: scalar} dict (names it lacks
    do not move): vertex gradients at silhouettes dwarf material ones.
    ``whitted_iters`` None measures the trip count
    (``resolve_whitted_iters``). The gradients are taken over fresh leaves
    that share the parameters' storage, so ``scene``'s tensors never get a
    ``.grad`` or ``requires_grad``. Returns (loss, gradients in
    ``differentiable_params``' structure, the updated scene).
    """
    params = differentiable_params(scene)
    if whitted_iters is None:
        whitted_iters = resolve_whitted_iters(scene, rays, bg_radiance, key)
    leaves = [p.detach().requires_grad_() for p in _flat(params)]
    with torch.enable_grad():
        img = _integrator(scene, whitted_iters)(
            scene_with_params(scene, _unflat(params, leaves)), rays,
            bg_radiance, rng.fold_in(key, 0))
        loss = torch.sum((img - target) ** 2) / (3.0 * rays.o.x.shape[0])
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = _unflat(params, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, got)])

    def rate(name):
        return lr.get(name, 0.0) if isinstance(lr, dict) else lr

    with torch.no_grad():
        new_params = {
            name: (tuple(p_ - rate(name) * g_ for p_, g_ in zip(p, grads[name]))
                   if isinstance(p, tuple) else p - rate(name) * grads[name])
            for name, p in params.items()}
    return loss.detach(), grads, scene_with_params(scene, new_params)
