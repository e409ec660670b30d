"""raytracer795_tpu_torch — the ray tracer on PyTorch and CUDA.

A port of ``raytracer795_tpu`` (JAX on a TPU), which stays in the
repository as the reference. This package imports torch and never jax.

- Scenes are dataclasses of tensors on one explicit ``device``, carried
  from ``load_scene`` down; nothing picks a device on its own.
- Rays are wavefront batches of lane-major ``Vec3`` tensors in the JAX
  package's tile-swizzled lane order; float32 throughout, with the JAX
  package's operation order.
- BVH traversal on CUDA runs hand-written kernels
  (csrc/bvh_traverse.cu, ops/bvh_traverse.py); on the CPU it runs their
  plain PyTorch versions.

Ported so far: the forward 1-spp Whitted render (point, directional and
spot lights, mirrors, conductors, dielectrics, the eight BRDFs, spheres,
meshes, transforms, instances). See ROADMAP.md for the rest.
"""

from raytracer795_tpu_torch.render import render_camera, render_scene
from raytracer795_tpu_torch.scene.loader import load_scene

__all__ = ["load_scene", "render_scene", "render_camera"]
