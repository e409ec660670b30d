"""Lane-sharded rendering, differentiable scene parameters and the
inverse-rendering train step.

Counterpart of ``raytracer795_tpu/parallel/shard.py``. A mesh is a plain
list of ``torch.device``; the same device may appear more than once, so
the split, the per-shard keys and the all-reduce run on one card or on the
CPU as they do over several cards. Lanes are block-split over the mesh
(their count must divide by its size; callers pad), shard ``i`` renders on
``mesh[i]`` with key ``fold_in(key, i)``, the scene is copied once to each
distinct device, and outputs come back in lane order on ``mesh[0]``. The
shards run one after another from this process; ``parallel/distributed.py``
spreads bands over processes.

The train step's all-reduce (the JAX package's ``psum``) sums each shard's
loss and gradients on ``mesh[0]`` in shard order, so its result is
deterministic. With ``mesh=None`` the step runs on the scene's device
alone: the JAX package's step on a one-device mesh, the key folded with 0,
the loss ``sum((img - target)^2) / (3 N)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from raytracer795_tpu_torch.models import path_tracer, whitted
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils import rng
from raytracer795_tpu_torch.utils.vec3 import Vec3

Params = Dict[str, Any]
Mesh = List[torch.device]


def make_ray_mesh(n_devices: int | None = None) -> Mesh:
    """This process's CUDA devices (the first ``n_devices``) as a mesh.
    Raises without a CUDA device: there is no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_ray_mesh lists CUDA devices, and CUDA is "
                           "not available; pass a mesh such as "
                           "[torch.device('cpu')] * 4 instead")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:n_devices] if n_devices is not None else devs


def _device(dev) -> torch.device:
    """``dev`` with its index: "cuda" names the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _to(obj, device: torch.device, memo: dict):
    """``obj`` (a scene structure) with every tensor on ``device``; an
    object reached twice (the BVH that instances share) is moved once."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, tuple):
        items = [_to(x, device, memo) for x in obj]
        out = type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device, memo)
            for f in dataclasses.fields(obj)})
    else:
        return obj
    memo[id(obj)] = out
    return out


def _replicas(scene: T.Scene, mesh: Sequence) -> Dict[torch.device, T.Scene]:
    """The scene on every distinct device of the mesh, copied once each;
    on its own device it is the scene itself."""
    out = {scene.device: scene}
    for dev in mesh:
        if dev not in out:
            out[dev] = _to(scene, dev, {})
    return out


def pad_to_multiple(n: int, m: int) -> int:
    """The least multiple of ``m`` at or above ``n``: a lane count that
    splits over a mesh of ``m`` devices."""
    return ((n + m - 1) // m) * m


def _slices(n: int, mesh: Sequence) -> List[slice]:
    if n % len(mesh):
        raise ValueError(f"{n} lanes do not split over a mesh of "
                         f"{len(mesh)} devices; pad the lanes")
    per = n // len(mesh)
    return [slice(i * per, (i + 1) * per) for i in range(len(mesh))]


def shard_rays(rays: intersect.Rays, mesh: Sequence) -> List[intersect.Rays]:
    """The lanes block-split over the mesh: shard ``i`` on ``mesh[i]``."""
    mesh = [_device(d) for d in mesh]
    return [_to(intersect.Rays(
        o=Vec3(*(c[sl] for c in rays.o)), d=Vec3(*(c[sl] for c in rays.d)),
        time=rays.time[sl]), dev, {})
        for sl, dev in zip(_slices(rays.time.shape[0], mesh), mesh)]


def _shards(scene: T.Scene, rays: intersect.Rays, bg_radiance: Vec3,
            mesh: Sequence):
    """(scene, rays, background, lane slice) of each shard in mesh order,
    the first three on the shard's device."""
    mesh = [_device(d) for d in mesh]
    scenes = _replicas(scene, mesh)
    for dev, sl, r in zip(mesh, _slices(rays.time.shape[0], mesh),
                          shard_rays(rays, mesh)):
        yield scenes[dev], r, Vec3(*(c[sl].to(dev) for c in bg_radiance)), sl


def _forward(scene: T.Scene) -> Callable:
    if scene.renderer == "pathtracing":
        return path_tracer.render_rays
    return whitted.render_rays


@torch.no_grad()
def render_rays_sharded(scene: T.Scene, rays: intersect.Rays,
                        bg_radiance: Vec3, key: rng.Key,
                        mesh: Sequence) -> torch.Tensor:
    """Radiance [N, 3] on ``mesh[0]`` of a ray batch whose lanes are split
    over the mesh (N must divide by its size), shard ``i`` rendered on
    ``mesh[i]`` with key ``fold_in(key, i)``."""
    first = _device(mesh[0])
    return torch.cat([
        _forward(sc)(sc, r, bg, rng.fold_in(key, i)).to(first)
        for i, (sc, r, bg, _) in enumerate(_shards(scene, rays, bg_radiance,
                                                   mesh))])


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
               whitted_iters: int | None = None, mesh: Sequence | None = None
               ) -> Tuple[torch.Tensor, T.Scene]:
    """One inverse-rendering step; returns (loss, new scene)."""
    loss, _, new_scene = train_step_with_grads(scene, rays, bg_radiance,
                                               target, key, lr, whitted_iters,
                                               mesh)
    return loss, new_scene


def _shard_loss_grads(scene, rays, bg, target, key, whitted_iters, n_total):
    """One shard's loss ``sum((img - target)^2) / (3 n_total)`` and its
    gradients, in ``_flat`` order. The gradients are taken over fresh
    leaves that share the parameters' storage, so the scene's tensors never
    get a ``.grad`` or ``requires_grad``."""
    params = differentiable_params(scene)
    leaves = [p.detach().requires_grad_() for p in _flat(params)]
    with torch.enable_grad():
        img = _integrator(scene, whitted_iters)(
            scene_with_params(scene, _unflat(params, leaves)), rays, bg, key)
        loss = torch.sum((img - target) ** 2) / (3.0 * n_total)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, got)]


def train_step_with_grads(scene: T.Scene, rays: intersect.Rays,
                          bg_radiance: Vec3, target: torch.Tensor,
                          key: rng.Key, lr=1e-2,
                          whitted_iters: int | None = None,
                          mesh: Sequence | None = None
                          ) -> Tuple[torch.Tensor, Params, T.Scene]:
    """One inverse-rendering step: render, MSE against ``target`` [N, 3],
    gradients of every differentiable parameter, one SGD update.

    ``lr`` is a scalar or a {parameter name: scalar} dict (names it lacks
    do not move): vertex gradients at silhouettes dwarf material ones.
    ``whitted_iters`` None measures the trip count
    (``resolve_whitted_iters``, over all the lanes). ``mesh`` splits the
    lanes (N must divide by its size): shard ``i`` renders its lanes on
    ``mesh[i]`` with key ``fold_in(key, i)``, and the losses and gradients
    are summed on ``mesh[0]`` in shard order. ``None`` is the scene's
    device alone. Returns (loss, gradients in ``differentiable_params``'
    structure, the updated scene), on ``mesh[0]``.
    """
    if whitted_iters is None:
        whitted_iters = resolve_whitted_iters(scene, rays, bg_radiance, key)
    n_total = rays.time.shape[0]
    base = loss = flat = None
    for i, (sc, r, bg, sl) in enumerate(_shards(
            scene, rays, bg_radiance, [scene.device] if mesh is None
            else mesh)):
        shard_loss, shard_grads = _shard_loss_grads(
            sc, r, bg, target[sl].to(sc.device), rng.fold_in(key, i),
            whitted_iters, n_total)
        if base is None:        # shard 0: the sums start on its device
            base, loss, flat = sc, shard_loss, shard_grads
        else:
            loss = loss + shard_loss.to(base.device)
            flat = [a + b.to(base.device) for a, b in zip(flat, shard_grads)]
    params = differentiable_params(base)
    grads = _unflat(params, flat)

    def rate(name):
        return lr.get(name, 0.0) if isinstance(lr, dict) else lr

    with torch.no_grad():
        new_params = {
            name: (tuple(p_ - rate(name) * g_ for p_, g_ in zip(p, grads[name]))
                   if isinstance(p, tuple) else p - rate(name) * grads[name])
            for name, p in params.items()}
    return loss, grads, scene_with_params(base, new_params)
