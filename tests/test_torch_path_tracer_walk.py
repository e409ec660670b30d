"""The port's path tracer against the JAX package: the estimators without
next-event estimation, the plain BVH walks, and the furnace.

- cornellbox_pt at 24x24, 4 spp, depth 3, under the "brute" and
  "uniform" RendererParams of tests/test_path_tracer.py:86-91;
- cornellbox_pt loaded with ``bvh_min_tris=2`` in both packages, so the
  port's plain BVH walks (its kernels' CPU path) carry every bounce and
  NEE ray;
- furnace at 16x16, 8 spp.

Bounds as in test_torch_path_tracer.py, whose helpers these tests share.
"""

import os

import pytest
import torch

import conftest
from test_torch_path_tracer import (assert_frames_agree, cornell_matches_jax,
                                    render_both, variant)

torch.set_num_threads(1)


@pytest.mark.parametrize("params", ["ImportanceSampling", ""])
def test_cornell_matches_jax(params, tmp_path):
    cornell_matches_jax(params, tmp_path)


def test_cornell_on_bvh_walk_matches_jax(tmp_path):
    """bvh_min_tris=2: the box's walls and light are one BVH group."""
    got, want, pl = render_both(variant(tmp_path, "cornellbox_pt", depth=3),
                                24, 4, bvh_min_tris=2)
    assert any(g.bvh is not None for g in pl.scene.groups)
    assert_frames_agree(got, want)


def test_furnace_matches_jax():
    got, want, _ = render_both(os.path.join(conftest.SCENES, "furnace.xml"),
                               16, 8, seed=2)
    assert_frames_agree(got, want)
