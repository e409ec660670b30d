"""Multi-process rendering on ``torch.distributed``: bands dealt over
processes, lanes split over each process's mesh, one film gather.

Counterpart of ``raytracer795_tpu/parallel/distributed.py``:

- ``initialize()`` joins the process group that ``torch.distributed.run``
  describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``); with none of them set it does nothing and returns 0, so
  every entry point runs unchanged as one process. The group is gloo: the
  film is a host array, and NCCL refuses two ranks on one card.
- ``render_camera_distributed()`` renders one camera through
  ``render.render_camera``'s bands and chunks (one code path): band ``b``
  belongs to process ``b % world_size`` (the reference deals pixel columns
  to threads modulo their count, pages/Page3.md:101), an owned band's lanes
  are split over this process's mesh (``shard.render_rays_sharded``), and
  one ``all_gather`` sums the per-process films on the host, in rank
  order. The other processes' bands stay 0 here and launch nothing.

A band's film is a pure function of (scene, camera, seed, band), so any
process count gives the one-process film bit for bit where the shading
draws no random numbers (the lane split folds each shard's key with its
index, as the JAX package does).

CLI::

    python -m torch.distributed.run --nproc_per_node N \\
        -m raytracer795_tpu_torch.parallel.distributed scene.xml \\
        [-o OUTDIR] [--spp N] [--seed N] [--device cuda]

Rank 0 writes the images. ``--device cuda`` (the default) renders on
``cuda:(LOCAL_RANK % device_count)`` and raises without CUDA; ``--device
cpu`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from raytracer795_tpu_torch import render
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.parallel import shard
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.loader import load_scene
from raytracer795_tpu_torch.utils import image_io
from raytracer795_tpu_torch.utils.vec3 import Vec3

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")
# ranks render different bands and reach the film gather at different times
_TIMEOUT = datetime.timedelta(hours=1)


def initialize(init_method: str | None = None) -> int:
    """Join the gloo process group described by the environment (or by
    ``init_method``, with ``RANK`` and ``WORLD_SIZE``); returns this
    process's rank, 0 when no group is described."""
    if init_method is None and not any(k in os.environ for k in _ENV):
        return 0
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=init_method or "env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), timeout=_TIMEOUT)
    return dist.get_rank()


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _pad_lanes(rays: intersect.Rays, multiple: int):
    """The rays padded with NaN rays (they hit nothing) to a multiple of
    ``multiple`` lanes, and the count before padding."""
    n = rays.time.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return rays, n

    def padf(x):
        return torch.cat([x, torch.full((pad,), float("nan"), dtype=x.dtype,
                                        device=x.device)])
    return intersect.Rays(o=Vec3(*map(padf, rays.o)),
                          d=Vec3(*map(padf, rays.d)),
                          time=padf(rays.time)), n


def _band_split(mesh, rank: int, world: int):
    """``render_camera``'s ``_distribute``: this process's bands, and an
    integrator that splits a band's lanes over ``mesh``."""
    def owns(band: int) -> bool:
        return band % world == rank

    def integrate(scene, rays, bg, key):
        rays, n = _pad_lanes(rays, len(mesh))
        pad = rays.time.shape[0] - n
        if pad:
            bg = Vec3(*(torch.cat([c, c.new_zeros(pad)]) for c in bg))
        return shard.render_rays_sharded(scene, rays, bg, key, mesh)[:n]
    return owns, integrate


def render_camera_distributed(loaded: T.LoadedScene, cam_index: int = 0,
                              seed: int = 0, mesh=None,
                              spp: int | None = None) -> np.ndarray:
    """One camera's float32 film [ny, nx, 3] over every process: this
    process renders its bands with their lanes split over ``mesh`` (the
    scene's device by default), and the films are summed on every process
    by one ``all_gather``."""
    rank, world = _rank_and_size()
    mesh = [loaded.scene.device] if mesh is None else mesh
    film = render.render_camera(loaded, cam_index, seed=seed, spp=spp,
                                _distribute=_band_split(mesh, rank, world))
    if world == 1:
        return film
    mine = torch.from_numpy(film)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-process renderer (launch with "
                    "python -m torch.distributed.run)")
    ap.add_argument("scene", help="scene XML file (reference contract)")
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--spp", type=int, default=None,
                    help="override NumSamples for every camera")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (this rank's card) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but CUDA is not available; "
                               "pass --device cpu to render on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)
    rank = initialize()
    _, world = _rank_and_size()
    loaded = load_scene(args.scene, device)
    os.makedirs(args.out_dir, exist_ok=True)
    try:
        for i, cam in enumerate(loaded.cameras):
            film = render_camera_distributed(loaded, i, seed=args.seed,
                                             spp=args.spp)
            if rank == 0:
                image_io.save_image(
                    os.path.join(args.out_dir, cam.image_name), film)
                print(f"[distributed] {cam.image_name}: {cam.nx}x{cam.ny} "
                      f"on {world} processes, {device}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
