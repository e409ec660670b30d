"""The port's multi-process render on torch.distributed (ports of
tests/test_distributed.py:64, 119).

Two real processes join a gloo group over loopback (``MASTER_ADDR``
127.0.0.1, ``GLOO_SOCKET_IFNAME`` lo, a free port), each with one CPU
thread, and run under a 120 s timeout; a child's failure fails the test.
- cornellbox at 4 spp with ``MAX_LANES = 1 << 14`` (10 bands of 20 rows,
  dealt over the two processes modulo 2) assembles the film of the
  one-process ``render_camera`` bit for bit;
- the CLI (``raytracer795_tpu_torch.parallel.distributed.main``) writes
  the PNG from rank 0 only, equal to the one-process frame.
One process alone (no group) renders the same film, with its lanes split
over a two-device mesh; ``initialize`` without a group is a no-op, and
``--device cuda`` without a card raises.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(conftest.SCENES, "cornellbox.xml")
BAND_LANES = 1 << 14        # 200x200 at 4 spp: 10 bands
CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from raytracer795_tpu_torch import render
from raytracer795_tpu_torch.parallel import distributed
render.MAX_LANES = %d
if sys.argv[1] == "film":
    from raytracer795_tpu_torch.scene.loader import load_scene
    rank = distributed.initialize()
    film = distributed.render_camera_distributed(
        load_scene(sys.argv[2], "cpu"), 0, seed=0, spp=4)
    np.save(sys.argv[3] + str(rank) + ".npy", film)
    torch.distributed.destroy_process_group()
else:
    distributed.main(sys.argv[2:])
""" % BAND_LANES


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(*args):
    """Run CHILD with ``args`` as ranks 0 and 1; returns their outputs."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _one_process(monkeypatch, spp, ldr=False):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene.loader import load_scene

    monkeypatch.setattr(render, "MAX_LANES", BAND_LANES)
    ld = load_scene(SCENE, "cpu")
    assert render.band_rows(render.with_spp(ld.cameras[0], 4)) == 20
    return render.render_camera(ld, 0, seed=0, spp=spp, ldr=ldr)


def test_two_process_film_equals_one_process(tmp_path, monkeypatch):
    prefix = str(tmp_path / "film")
    _run_two("film", SCENE, prefix)
    film0, film1 = (np.load(f"{prefix}{r}.npy") for r in range(2))
    want = _one_process(monkeypatch, 4)
    assert film0.dtype == np.float32 and film0.max() > 0
    np.testing.assert_array_equal(film0, want)
    np.testing.assert_array_equal(film1, want)       # every rank sums


def test_two_process_cli_writes_from_rank_0(tmp_path, monkeypatch):
    from raytracer795_tpu_torch.utils.image_io import read_png

    outs = _run_two("cli", SCENE, "-o", str(tmp_path), "--spp", "2",
                    "--device", "cpu")
    assert "[distributed] cornellbox.png" in outs[0]
    assert "[distributed]" not in outs[1]
    assert os.listdir(tmp_path) == ["cornellbox.png"]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "cornellbox.png")),
        _one_process(monkeypatch, 2, ldr=True).astype(np.float32))


def test_one_process_with_a_lane_split(monkeypatch):
    from raytracer795_tpu_torch.parallel import distributed
    from raytracer795_tpu_torch.scene.loader import load_scene

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() == 0
    assert not torch.distributed.is_initialized()
    want = _one_process(monkeypatch, 1)
    got = distributed.render_camera_distributed(
        load_scene(SCENE, "cpu"), 0, seed=0, spp=1,
        mesh=[torch.device("cpu")] * 2)
    np.testing.assert_array_equal(got, want)


def test_pad_lanes_with_nan_rays():
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.parallel import distributed
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    v = torch.arange(5, dtype=torch.float32)
    rays = intersect.Rays(o=Vec3(v, v, v), d=Vec3(v, v, v), time=v)
    padded, n = distributed._pad_lanes(rays, 4)
    assert n == 5 and padded.time.shape == (8,)
    assert torch.equal(padded.o.x[:5], v)
    assert bool(torch.isnan(padded.d.z[5:]).all())
    assert distributed._pad_lanes(rays, 5) == (rays, 5)


def test_cli_refuses_cuda_without_a_device(monkeypatch, tmp_path):
    from raytracer795_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.main([SCENE, "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)
