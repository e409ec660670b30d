"""Render the JAX package's frame of rock100k_tex, the reference that the
PyTorch port's frame on the card is held against.

    JAX_PLATFORMS=cpu python tools/torch_make_tex_reference.py [--res N]

Renders tests/scenes/rock100k_tex.xml (rock100k with Perlin, image and
bump textures and a JPEG background) at N x N (default 400), 1 spp, seed 0,
with ``raytracer795_tpu.render.render_camera(..., ldr=True)`` on the CPU,
writes tests/goldens/rock100k_tex_jax.ppm and prints how long it took. It
uses the XLA flags of tests/conftest.py (backend optimization level 0), so
the frame is the one the CPU tests' JAX renders give. This tool imports the
JAX package; the port and chip_smoke.py only read the .ppm it writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "")
if "xla_backend_optimization_level" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from raytracer795_tpu.render import render_camera  # noqa: E402
from raytracer795_tpu.scene.loader import load_scene  # noqa: E402
from raytracer795_tpu.utils.image_io import write_ppm  # noqa: E402

SCENE = os.path.join(HERE, "tests", "scenes", "rock100k_tex.xml")
OUT = os.path.join(HERE, "tests", "goldens", "rock100k_tex_jax.ppm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("-o", "--out", default=OUT)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    loaded = load_scene(SCENE)
    loaded.cameras[0] = dataclasses.replace(loaded.cameras[0], nx=args.res,
                                            ny=args.res)
    load_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    img = render_camera(loaded, 0, seed=0, ldr=True)
    render_s = time.perf_counter() - t1
    write_ppm(args.out, img)
    print(f"{os.path.relpath(args.out, HERE)}: {args.res}x{args.res}, load "
          f"{load_s:.1f} s, render {render_s:.1f} s, mean {img.mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
