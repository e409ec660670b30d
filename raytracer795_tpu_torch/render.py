"""Render entry points + CLI: scene in, images out.

Counterpart of ``raytracer795_tpu/render.py`` for 1-spp Whitted frames.
Frames tile into row bands of at most ``MAX_LANES`` lanes, lanes come in
the tile-swizzled order of ``camera.band_pixels``, and each band is
quantized to LDR on the device before it crosses to the host.

CLI::

    python -m raytracer795_tpu_torch.render scene.xml [-o OUTDIR] [--device cuda]

``--device`` defaults to ``cuda``; without a CUDA device the CLI raises
instead of rendering on the CPU. ``--device cpu`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _time

import numpy as np
import torch

from raytracer795_tpu_torch.models import camera as camera_model
from raytracer795_tpu_torch.models import whitted
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.loader import load_scene
from raytracer795_tpu_torch.utils import image_io
from raytracer795_tpu_torch.utils.vec3 import Vec3

# Max lanes per band (the JAX package's budget; not yet retuned for the card)
MAX_LANES = 1 << 18


def band_rows(cam: T.Camera) -> int:
    """Rows per band: the whole frame when it fits MAX_LANES, else a
    multiple of the swizzle tile height."""
    band = min(cam.ny, max(1, MAX_LANES // cam.nx))
    if band < cam.ny and band > camera_model.TILE_H:
        band -= band % camera_model.TILE_H
    return band


def render_band(scene: T.Scene, cam: T.Camera, px: torch.Tensor,
                py: torch.Tensor) -> torch.Tensor:
    """Radiance [N, 3] of per-lane frame pixels (px, py): center-of-pixel
    rays (src/Scene.cpp:365-384) through the lane machine."""
    rays = camera_model.primary_rays_at(cam, px, py)
    n = px.shape[0]
    bg = scene.background
    bg_radiance = Vec3(bg[0].expand(n), bg[1].expand(n), bg[2].expand(n))
    return whitted.render_rays(scene, rays, bg_radiance)


def render_camera(loaded: T.LoadedScene, cam_index: int = 0,
                  ldr: bool = False) -> np.ndarray:
    """Render one camera to a [ny, nx, 3] image on the host.

    Float32 radiance, or with ``ldr=True`` uint8 quantized on the device:
    clamp to [0, 255] and truncate, bitwise what ``to_ldr`` of the float
    image gives (src/Image.cpp:64-69). Each band is traced in tile-swizzled
    lane order and put back in row order on the device.
    """
    scene = loaded.scene
    cam = loaded.cameras[cam_index]
    if scene.renderer != "whitted":
        raise NotImplementedError(
            "the path tracer is not ported yet: ROADMAP queue 1 item 13")
    if cam.num_samples > 1:
        raise NotImplementedError(
            "multi-sample cameras need the RNG that matches JAX: ROADMAP "
            "queue 1 items 10 and 12")
    band = band_rows(cam)
    film = np.empty((cam.ny, cam.nx, 3), np.uint8 if ldr else np.float32)
    for row0 in range(0, cam.ny, band):
        rows = min(band, cam.ny - row0)
        px, py_rel = camera_model.band_pixels(cam.nx, rows, scene.device)
        out = render_band(scene, cam, px, row0 + py_rel)
        if ldr:
            out = torch.clamp(out, 0.0, 255.0).to(torch.uint8)
        flat = torch.empty_like(out)
        flat[camera_model.band_unswizzle_index(px, py_rel, cam.nx)] = out
        film[row0:row0 + rows] = flat.cpu().numpy().reshape(rows, cam.nx, 3)
    return film


def scene_stats(scene: T.Scene) -> dict:
    """Primitive counts, BVH shape and the traversal tables' bytes."""
    tris = sum(g.n_tris for g in scene.groups)
    spheres = sum(g.n_spheres for g in scene.groups)
    nodes = 0
    table_bytes = 0
    for g in scene.groups:
        flats = (g.bvh,) if g.bvh is not None else g.pack_bvhs or ()
        if flats:
            m = sum(int(f.first.shape[0]) for f in flats)
            nodes += m
            # ops/bvh_traverse.py: 32 B + 4 B a node, 64 B a triangle
            table_bytes += 36 * m + 64 * g.n_tris
    n_lights = int(scene.lights.point_pos.shape[0]
                   + scene.lights.dir_dir.shape[0]
                   + scene.lights.spot_pos.shape[0]
                   + scene.lights.area_pos.shape[0])
    return {
        "renderer": scene.renderer, "max_depth": int(scene.max_depth),
        "tris": int(tris), "spheres": int(spheres),
        "groups": len(scene.groups), "bvh_nodes": int(nodes),
        "packs": sum(len(g.pack_bvhs or ()) for g in scene.groups),
        "traverse_table_mb": round(table_bytes / 1e6, 2),
        "lights": n_lights, "textures": int(scene.n_textures),
    }


def log_render_stats(scene: T.Scene, cam: T.Camera, seconds: float,
                     stream=None) -> dict:
    """Emit ONE JSON line per render to stderr, naming the device.

    ``rays_per_s`` counts every lane for every bounce: 1 extension ray plus
    1 occlusion ray per light (the JAX package's gross accounting).
    """
    dev = scene.device
    st = scene_stats(scene)
    lanes = cam.nx * cam.ny
    rays = lanes * st["max_depth"] * (1 + st["lights"])
    rec = {
        "event": "render", "image": cam.image_name,
        "res": [cam.nx, cam.ny], "spp": 1,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "seconds": seconds,
        "rays_per_s": rays / max(seconds, 1e-9),
        **st,
    }
    print(json.dumps(rec), file=stream or sys.stderr)
    return rec


def render_scene(loaded: T.LoadedScene, out_dir: str = ".") -> list:
    """Render every camera and write its image (src/Scene.cpp:330-362)."""
    paths = []
    for i, cam in enumerate(loaded.cameras):
        if cam.tonemap is not None:
            raise NotImplementedError(
                "tonemapping is not ported yet: ROADMAP queue 1 item 16")
        lower = cam.image_name.lower()
        ldr = ".png" in lower or ".ppm" in lower
        t0 = _time.perf_counter()
        img = render_camera(loaded, i, ldr=ldr)
        dt = _time.perf_counter() - t0
        path = os.path.join(out_dir, cam.image_name)
        image_io.save_image(path, img)
        print(f"[raytracer795_tpu_torch] {cam.image_name}: "
              f"{cam.nx}x{cam.ny} spp=1 in {dt:.3f}s")
        log_render_stats(loaded.scene, cam, dt)
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description="ray tracer on PyTorch and CUDA")
    ap.add_argument("scene", help="scene XML file (reference contract)")
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override NumSamples; only 1 is ported")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="film checkpoints (not ported yet)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but CUDA is not available; pass --device cpu "
            "to render on the CPU")
    if args.spp not in (None, 1):
        raise NotImplementedError(
            "multi-sample rendering needs the RNG that matches JAX: ROADMAP "
            "queue 1 items 10 and 12")
    if args.checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet: ROADMAP queue 1 item 16")
    loaded = load_scene(args.scene, device)
    os.makedirs(args.out_dir, exist_ok=True)
    render_scene(loaded, args.out_dir)


if __name__ == "__main__":
    main()
