"""Chip smoke test: the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failed check raises, so the script exits
non-zero and prints no result:

1. device: require CUDA; print the card's name and power limit.
2. build: compile csrc/bvh_traverse.cu with nvcc (sm_90a) into build/.
3. kernel vs plain, on the card: random meshes with NaN, zero and d == 0
   rays, then rock100k's own primary wavefront (400x400, 160k rays) and its
   first shadow wavefront. Hit masks, prim ids and any-hit answers must be
   equal, t within 2e-5.
4. main path: ``render_scene`` of tests/scenes/rock100k.xml on cuda, with
   both kernels' launch counters reset just before and read just after;
   the frame must match tests/goldens/rock100k.ppm at
   frac(|dLDR| > 1) < 1e-4. The six texture-free deterministic goldens
   (simple, cornellbox, brdfs, lights, transforms, instances) must meet
   their bounds.
5. times on this card: median of 5 rock100k frames after a warm-up at
   400x400 and 800x800 (1 spp), and kernel vs plain walk times for one
   primary and one shadow wavefront at 400x400.

The last two lines are the kernels' JSON record and the result line.
It imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "tests", "scenes")
GOLDENS = os.path.join(HERE, "tests", "goldens")
OUT = os.path.join(HERE, "build", "chip_smoke")
T_TOL = 2e-5
FRAME_RES = (400, 800)      # rock100k frame sizes timed in phase 5
FRAME_REPS = 5
# the texture-free deterministic goldens: (scene, mean tol, frac>2 tol) of
# tests/test_golden.py:22-33
GOLDEN_BOUNDS = (("simple", 0.01, 0.001), ("cornellbox", 0.01, 0.001),
                 ("brdfs", 0.01, 0.001), ("lights", 0.01, 0.001),
                 ("transforms", 0.2, 0.01), ("instances", 0.2, 0.01))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def png_pixels(path: str) -> np.ndarray:
    """Pixels of an 8-bit RGB PNG as the port writes it (filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(bt, tb, o, d, cap, eps):
    """Kernel vs plain walk on the card.

    Returns (max |dt| over hits, any-hit mismatches, hits, occluded)."""
    from raytracer795_tpu_torch.ops import intersect

    dec = bt.decode(tb)
    key, t, idx = bt.tri_bvh_nearest(tb, o, d, eps)
    found = bt.tri_bvh_anyhit(tb, o, d, cap, eps)
    pkey, pt, pidx = intersect._tri_bvh_candidates(dec, o, d, eps)
    pfound = intersect._tri_bvh_anyhit(dec, o, d, cap, eps)
    torch.cuda.synchronize()
    hit, phit = key < 1e38, pkey < 1e38
    check(torch.equal(hit, phit), "nearest hit masks differ")
    check(torch.equal(idx[hit], pidx[hit]), "nearest prim ids differ")
    err = float((t[hit] - pt[hit]).abs().max()) if hit.any() else 0.0
    check(err <= T_TOL, f"nearest t differs by {err}")
    mismatches = int((found != pfound).sum())
    check(mismatches == 0, f"{mismatches} any-hit answers differ")
    return err, mismatches, int(hit.sum()), int(found.sum())


def random_case(bt, t, n, seed, dev):
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    flat, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx))
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 16, 1] = 0.0
    o[n // 16: n // 8] = np.nan
    d[n // 8: 3 * n // 16] = 0.0
    cap = rng.uniform(0.1, 5.0, n).astype(np.float32)

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                      for k in range(3)))

    tb = bt.build_tables(to_device(flat, dev),
                         torch.from_numpy(verts).to(dev),
                         torch.from_numpy(tri_vidx[perm]).to(dev))
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return compare(bt, tb, col(o), col(d), torch.from_numpy(cap).to(dev), eps)


def rock_wavefronts(loaded):
    """rock100k's primary wavefront and its first shadow wavefront (light
    0), as the main path builds them; the scene is one untransformed group."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera, lights
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.ops.texture import apply_textures
    from raytracer795_tpu_torch.utils.vec3 import Vec3, vnorm

    scene, cam = loaded.scene, loaded.cameras[0]
    dev = scene.device
    check(render.band_rows(cam) == cam.ny, "400x400 is one band")
    px, py = camera.band_pixels(cam.nx, cam.ny, dev)
    rays = camera.primary_rays_at(cam, px, py)
    with torch.no_grad():
        hit = intersect.trace(scene, rays)
        det = intersect.hit_details(scene, rays, hit,
                                    intersect.compute_vertex_normals(scene))
        tex = apply_textures(scene, det)
        sp = lights.ShadePoint(
            point=det.point, normal=tex.normal, wo=-rays.d, mat=det.mat,
            dm=tex.dm, tex_color=tex.tex_color, tex_norm=tex.tex_normalizer,
            time=rays.time, valid=hit.valid)
        pos = scene.lights.point_pos[0]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        shadow, cap = lights.shadow_rays(scene, sp, topoint * (1.0 / d_light),
                                         d_light)
    return rays, shadow, cap


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.ops import bvh_traverse as bt
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.scene.loader import load_scene
    from raytracer795_tpu_torch.utils.image_io import read_ppm

    # ---- 2. build ----
    _, build_s, log = bt.build_kernels()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    phase("build", seconds=build_s, ptxas=regs)

    # ---- 3. kernel vs plain on the card ----
    errs, mism = [], []
    for t, n, seed in ((333, 1500, 0), (2048, 4096, 1)):
        err, bad, hits, occ = random_case(bt, t, n, seed, dev)
        errs.append(err)
        mism.append(bad)
        phase("kernel_vs_plain", case=f"random mesh {t} tris, {n} rays",
              max_abs_t_err=err, anyhit_mismatches=bad, hits=hits,
              occluded=occ)
    rock_xml = os.path.join(SCENES, "rock100k.xml")
    loaded = load_scene(rock_xml, dev)
    (group,) = loaded.scene.groups
    check(group.bvh is not None, "rock100k is one BVH group")
    prim, shadow, cap = rock_wavefronts(loaded)
    tb = bt.build_tables(group.bvh, loaded.scene.vertices, group.tri_vidx)
    eps = loaded.scene.int_eps
    # nearest on the primary wavefront, any-hit on the shadow wavefront
    for case, rays, rcap in (
            ("rock100k primary wavefront", prim,
             torch.full_like(prim.o.x, 3.0e38)),
            ("rock100k first shadow wavefront", shadow, cap)):
        err, bad, hits, occ = compare(bt, tb, rays.o, rays.d, rcap, eps)
        errs.append(err)
        mism.append(bad)
        phase("kernel_vs_plain", case=case, rays=rays.o.x.shape[0],
              max_abs_t_err=err, anyhit_mismatches=bad, hits=hits,
              occluded=occ)

    # ---- 4. main path ----
    os.makedirs(OUT, exist_ok=True)
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    (png,) = render.render_scene(loaded, OUT)
    main_s = time.perf_counter() - t0
    launches = dict(bt.LAUNCHES)
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"the main path launched every kernel: {launches}")
    img = png_pixels(png).astype(np.float32)
    gold = read_ppm(os.path.join(GOLDENS, "rock100k.ppm"))
    check(img.shape == gold.shape, f"frame shape {img.shape}")
    frac = float((np.abs(img - gold) > 1).mean())
    check(frac < 1e-4, f"rock100k golden: frac(|d|>1) = {frac}")
    phase("main_path", scene="rock100k", seconds=main_s, launches=launches,
          golden_frac_gt1=frac)

    for name, mean_tol, frac_tol in GOLDEN_BOUNDS:
        ld = load_scene(os.path.join(SCENES, name + ".xml"), dev)
        img = render.render_camera(ld, 0, ldr=True).astype(np.float32)
        diff = np.abs(img - read_ppm(os.path.join(GOLDENS, name + ".ppm")))
        mean, frac2 = float(diff.mean()), float((diff > 2).mean())
        check(mean < mean_tol and frac2 < frac_tol,
              f"{name} golden: mean {mean}, frac>2 {frac2}")
        phase("golden", scene=name, mean_abs=mean, frac_gt2=frac2)

    # ---- 5. times on this card ----
    frames = {}
    for res in FRAME_RES:
        ld = load_scene(rock_xml, dev)
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
        render.render_camera(ld, 0, ldr=True)          # warm-up
        secs = []
        for _ in range(FRAME_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render.render_camera(ld, 0, ldr=True)
            secs.append(time.perf_counter() - t0)
        check(out.shape == (res, res, 3), f"{res} frame shape")
        frames[res] = statistics.median(secs)
        phase("frame_time", scene="rock100k", res=res, spp=1,
              median_s=frames[res], samples_s=secs, card=card)

    dec = bt.decode(tb)
    timing = {
        "nearest": (
            cuda_ms(lambda: bt.tri_bvh_nearest(tb, prim.o, prim.d, eps), 20),
            cuda_ms(lambda: intersect._tri_bvh_candidates(
                dec, prim.o, prim.d, eps), 1)),
        "anyhit": (
            cuda_ms(lambda: bt.tri_bvh_anyhit(tb, shadow.o, shadow.d, cap,
                                              eps), 20),
            cuda_ms(lambda: intersect._tri_bvh_anyhit(
                dec, shadow.o, shadow.d, cap, eps), 1)),
    }
    for name, (k_ms, p_ms) in timing.items():
        phase("kernel_time", kernel=name, wavefront="400x400 rock100k",
              kernel_ms=k_ms, plain_ms=p_ms, card=card)

    replaces = {"nearest": "raytracer795_tpu/ops/pallas_bvh.py:335",
                "anyhit": "raytracer795_tpu/ops/pallas_bvh.py:404"}
    # any-hit answers are booleans, so their |kernel - plain| is 0 or 1
    err_by = {"nearest": max(errs), "anyhit": float(max(mism) > 0)}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "raytracer795_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": err_by[name], "ms": timing[name][0],
        "plain_ms": timing[name][1]} for name in ("nearest", "anyhit")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
