"""Decal application for untextured hits.

Counterpart of ``apply_textures`` in ``raytracer795_tpu/ops/texture.py``
for scenes whose primitives reference no texture: every lane keeps
``DECAL_NONE``, texture color 0 and normalizer 1, and the local normal is
taken to world space by (M^-1)^T once per hit (src/Helper.cpp:75-78).
Image and Perlin textures are not ported yet (ROADMAP queue 1 item 11):
a scene that has any raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer795_tpu_torch.ops.intersect import HitDetails
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import Vec3, vmasked_normalize


class TexturedHit(NamedTuple):
    dm: torch.Tensor             # [N] int32 decal mode (DECAL_*)
    tex_color: Vec3
    tex_normalizer: torch.Tensor  # [N]
    normal: Vec3                 # world shading normal


def check_untextured(scene: T.Scene) -> None:
    """Raise for a scene with textures: none of their math is ported."""
    if scene.n_textures:
        raise NotImplementedError(
            "image and Perlin textures are not ported yet: ROADMAP queue 1 "
            "item 11")


def apply_textures(scene: T.Scene, det: HitDetails) -> TexturedHit:
    """Decal state and world normal of untextured hits."""
    check_untextured(scene)
    N = det.normal.x.shape[0]
    dev = det.normal.x.device
    world_n = vmasked_normalize(det.valid, det.minv_t.apply(det.normal))
    return TexturedHit(
        dm=torch.full((N,), T.DECAL_NONE, dtype=torch.int32, device=dev),
        tex_color=Vec3.zeros((N,), dev),
        tex_normalizer=torch.ones((N,), device=dev),
        normal=world_n)
