"""Per-stage pipeline profiler: where does a frame's time go?

Counterpart of ``raytracer795_tpu/profiling.py``. Every stage runs on one
primary-ray wavefront (camera 0 at res x res, 1 spp, image-row-major
lanes) and is timed alone, eagerly: one warm-up call (the kernels build
and the traversal tables are made), then the best of ``reps`` calls, each
between ``torch.cuda.synchronize()`` calls when the scene is on the card.
The stages are the JAX module's, in its order: ray generation, the nearest
hit, the any-hit (cap 100), hit details, textures, direct lighting and the
whole integrator.

CLI::

    python -m raytracer795_tpu_torch.profiling scene.xml [--res 512]
        [--reps 5] [--trace-dir DIR] [--device cuda]

prints one JSON line a stage, ``{"stage", "ms", "lanes_per_s"}``.
``--trace-dir`` also records one full frame under ``torch.profiler`` (the
CPU and, on the card, CUDA activities), writes it into DIR as a Chrome
trace and prints ``{"stage": "profiler_trace", "dir": DIR, "file": ...}``.
``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from raytracer795_tpu_torch import render
from raytracer795_tpu_torch.models import camera
from raytracer795_tpu_torch.models.lights import ShadePoint, direct_lighting
from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.ops.texture import apply_textures
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.loader import load_scene
from raytracer795_tpu_torch.utils import rng
from raytracer795_tpu_torch.utils.vec3 import Vec3

STAGES = ("ray_gen", "trace", "trace_anyhit", "hit_details",
          "apply_textures", "direct_lighting", "full_frame")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def stages(loaded: T.LoadedScene, res: int = 512):
    """(lanes, [(stage, fn)]): each stage of one res x res primary
    wavefront as a call without arguments, on the scene's device, in
    ``STAGES`` order. Its inputs are made once, here."""
    scene = loaded.scene
    dev = scene.device
    cam = dataclasses.replace(loaded.cameras[0], nx=res, ny=res,
                              num_samples=1, grid=1)
    rays = camera.primary_rays(cam, device=dev)
    n = rays.time.shape[0]
    key = rng.PRNGKey(0)
    bg = Vec3.zeros((n,), dev)
    vn = intersect.compute_vertex_normals(scene)
    hit = intersect.trace(scene, rays)
    det = intersect.hit_details(scene, rays, hit, vn)
    tex = apply_textures(scene, det)
    sp = ShadePoint(point=det.point, normal=tex.normal, wo=-rays.d,
                    mat=det.mat, dm=tex.dm, tex_color=tex.tex_color,
                    tex_norm=tex.tex_normalizer, time=rays.time,
                    valid=det.valid)
    integrate = render._integrator(scene)
    fns = {
        "ray_gen": lambda: camera.primary_rays(cam, device=dev),
        "trace": lambda: intersect.trace(scene, rays),
        "trace_anyhit": lambda: intersect.trace_anyhit(scene, rays, 100.0),
        "hit_details": lambda: intersect.hit_details(scene, rays, hit, vn),
        "apply_textures": lambda: apply_textures(scene, det),
        "direct_lighting": lambda: direct_lighting(scene, sp, key),
        "full_frame": lambda: integrate(scene, rays, bg, key),
    }
    return n, [(name, fns[name]) for name in STAGES]


@torch.no_grad()
def _best(fn, device: torch.device, reps: int) -> float:
    """Best host seconds of ``reps`` calls after one warm-up call, each
    ending in a synchronize on the card."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_scene(loaded: T.LoadedScene, res: int = 512, reps: int = 5):
    """[(stage, seconds, lanes/s)] for one primary-ray wavefront."""
    n, fns = stages(loaded, res)
    out = []
    for name, fn in fns:
        dt = _best(fn, loaded.scene.device, reps)
        out.append((name, dt, n / dt))
    return out


@torch.no_grad()
def trace_frame(loaded: T.LoadedScene, res: int, trace_dir: str) -> str:
    """One full frame (after a warm-up frame) recorded under
    ``torch.profiler`` and written into ``trace_dir`` as a Chrome trace;
    returns the file's path."""
    from torch.profiler import ProfilerActivity, profile

    dev = loaded.scene.device
    frame = dict(stages(loaded, res)[1])["full_frame"]
    frame()
    _sync(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        frame()
        _sync(dev)
    os.makedirs(trace_dir, exist_ok=True)
    name = os.path.splitext(loaded.cameras[0].image_name)[0]
    path = os.path.join(trace_dir, f"{name}_{res}x{res}_frame.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-stage render profiler")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", default=None,
                    help="record one frame under torch.profiler there")
    ap.add_argument("--device", default="cuda",
                    help="torch device to profile on (default cuda)")
    args = ap.parse_args(argv)

    loaded = load_scene(args.scene, render.cli_device(args.device))
    for name, dt, lps in profile_scene(loaded, args.res, args.reps):
        print(json.dumps({"stage": name, "ms": round(dt * 1e3, 3),
                          "lanes_per_s": round(lps, 1)}), flush=True)
    if args.trace_dir:
        path = trace_frame(loaded, args.res, args.trace_dir)
        print(json.dumps({"stage": "profiler_trace", "dir": args.trace_dir,
                          "file": path}), flush=True)


if __name__ == "__main__":
    main()
