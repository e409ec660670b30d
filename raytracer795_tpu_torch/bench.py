"""Headline benchmark: the Cornell-box path trace, rays/s on one card.

    python -m raytracer795_tpu_torch.bench

Counterpart of the repository root's ``bench.py``, with its configuration:
tests/scenes/cornellbox_pt.xml (Monte Carlo path tracing with NEE and
importance sampling, a mirror and a dielectric sphere, a mesh light, 6
bounces) at ``BENCH_RES`` x ``BENCH_RES`` (800) and ``BENCH_SPP`` (4)
samples a pixel, on ``cuda``. It prints one JSON line on stdout::

    {"metric", "value", "unit": "rays/s", "net_rays_per_s", "best_s",
     "median_s", "frame_s", "rays_gross", "rays_net", "card"}

``value`` is the gross count of ``render.gross_rays`` (every lane billed
for every bounce: one extension ray and one occlusion ray a light) over
the best of 5 LDR frames, each ending with the frame on the host, after
one warm-up frame. ``net_rays_per_s`` is ``render.count_net_rays`` (the
rays live lanes trace, counted in one more render of seed 1, outside the
timed frames) over the same best frame. The render's log line, with
``rays_net``, goes to stderr.

Departures from the root script:
- no ``vs_baseline`` or ``net_vs_baseline``: they divide by a TPU north
  star, and the port states no TPU number;
- ``card`` (the ``nvidia-smi --query-gpu=name,power.limit`` line),
  ``median_s`` and every frame's seconds: frame medians of one tree have
  moved by up to 2x between runs, so the spread goes beside the best.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import torch

from raytracer795_tpu_torch import render
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.loader import load_scene

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "scenes")
SCENE = os.path.join(SCENES, "cornellbox_pt.xml")
RES = int(os.environ.get("BENCH_RES", "800"))
SPP = int(os.environ.get("BENCH_SPP", "4"))
REPS = 5


def card_name(device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it,
    e.g. "NVIDIA H100 80GB HBM3, 700.00 W"; another device by its type."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True).stdout.strip()


def with_frame(loaded: T.LoadedScene, res: int, spp: int) -> T.LoadedScene:
    """A copy of ``loaded`` whose camera 0 renders res x res at ``spp``."""
    cam = render.with_spp(dataclasses.replace(loaded.cameras[0], nx=res,
                                              ny=res), spp)
    return dataclasses.replace(loaded, cameras=[cam, *loaded.cameras[1:]])


def measure(loaded: T.LoadedScene, reps: int) -> dict:
    """Gross and net rays/s of camera 0: ``reps`` LDR frames (seeds 1 to
    reps) after a warm-up frame (seed 0), then the net count (seed 1); the
    render's log line goes to stderr."""
    render.render_camera(loaded, 0, seed=0, ldr=True)
    secs = []
    for i in range(reps):
        t0 = time.perf_counter()
        render.render_camera(loaded, 0, seed=i + 1, ldr=True)
        secs.append(time.perf_counter() - t0)
    best = min(secs)
    net = render.count_net_rays(loaded, 0, seed=1)
    gross = render.gross_rays(loaded.scene, loaded.cameras[0])
    render.log_render_stats(loaded.scene, loaded.cameras[0], best,
                            net_rays=net)
    return {"value": round(gross / best, 1), "unit": "rays/s",
            "net_rays_per_s": round(net / best, 1), "best_s": best,
            "median_s": statistics.median(secs), "frame_s": secs,
            "rays_gross": gross, "rays_net": net,
            "card": card_name(loaded.scene.device)}


def bench_scene(res: int = RES, spp: int = SPP, device="cuda") -> dict:
    """Print and return the Cornell path trace's line at res x res and
    ``spp`` on ``device``."""
    loaded = with_frame(load_scene(SCENE, device), res, spp)
    scene = loaded.scene
    rec = {"metric": f"rays/s/card (Cornell path trace {res}x{res} {spp}spp,"
                     f" depth {scene.max_depth}, NEE+IS; gross device lanes"
                     f" - net live-lane number in net_rays_per_s)",
           **measure(loaded, REPS)}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    bench_scene(device=render.cli_device("cuda"))


if __name__ == "__main__":
    main()
