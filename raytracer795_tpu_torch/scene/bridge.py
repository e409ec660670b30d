"""Carry a JAX-package scene across into the port's types.

``scene_from_numpy`` takes the JAX package's ``Scene`` with every array leaf
given as a numpy array (``jax.tree_util.tree_map(np.asarray, scene)``
yields it) and returns the port's ``Scene`` on ``device``. It matches the
dataclasses by name and field: a group's ``bvh``, ``pack_bvhs`` and
``pack_share`` come across leaf for leaf, and the JAX package's TPU table
layout (``bvh_pack``) is left behind. The tests use it to feed both
packages the same scene.

This module never imports jax: it reads the input's fields by name.
"""

from __future__ import annotations

import dataclasses

from raytracer795_tpu_torch.scene import types as T


def _port(obj):
    if isinstance(obj, tuple):
        return tuple(_port(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(T, type(obj).__name__)
        fields = {f.name: _port(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)}
        return cls(**fields)
    return obj


def scene_from_numpy(scene_np, device) -> T.Scene:
    """The JAX package's scene (numpy leaves) as the port's Scene.

    Fields are read by the port's field names, so the JAX package's
    ``bvh_pack`` is left behind.
    """
    return T.to_device(_port(scene_np), device)
