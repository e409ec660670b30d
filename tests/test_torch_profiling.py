"""The port's stage profiler and its two bench entry points, on the CPU.

- ``profiling.profile_scene`` returns the JAX module's stages, in its
  order (read from the JAX ``profile_scene`` at 8x8), each with a time
  above 0 and lanes / time;
- ``profiling.main`` prints a JSON line a stage with the JAX keys, and
  with ``--trace-dir`` writes a Chrome trace and prints the
  ``profiler_trace`` line; without ``--device`` and without CUDA it raises;
- ``bench.bench_scene`` and ``bench_mesh.bench_scene`` at 16x16 on the CPU
  print one JSON line each with the JAX keys (less the TPU baselines), the
  card, the median beside the best, and net rays at most the gross.
"""

import json
import os

import pytest
import torch

import conftest

torch.set_num_threads(1)

CORNELL = os.path.join(conftest.SCENES, "cornellbox.xml")


@pytest.fixture(scope="module")
def jax_stages():
    from raytracer795_tpu import profiling as jax_profiling

    return [name for name, _, _ in jax_profiling.profile_scene(
        conftest.load("simple"), res=8, reps=1)]


def test_profile_scene_has_jax_stages(jax_stages):
    from raytracer795_tpu_torch import profiling
    from raytracer795_tpu_torch.scene.loader import load_scene

    out = profiling.profile_scene(load_scene(CORNELL, "cpu"), res=16, reps=1)
    assert [name for name, _, _ in out] == jax_stages
    assert list(profiling.STAGES) == jax_stages
    for name, seconds, lanes_per_s in out:
        assert seconds > 0, name
        assert lanes_per_s == pytest.approx(16 * 16 / seconds)


def test_main_prints_stages_and_writes_a_trace(jax_stages, tmp_path, capsys):
    from raytracer795_tpu_torch import profiling

    profiling.main([CORNELL, "--res", "8", "--reps", "1", "--device", "cpu",
                    "--trace-dir", str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["stage"] for ln in lines] == jax_stages + ["profiler_trace"]
    for ln in lines[:-1]:
        assert set(ln) == {"stage", "ms", "lanes_per_s"}
        assert ln["ms"] >= 0 and ln["lanes_per_s"] > 0
    assert lines[-1]["dir"] == str(tmp_path)
    path = lines[-1]["file"]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("name") == "aten::index" for ev in events)


def test_main_wants_cuda_by_default(monkeypatch):
    from raytracer795_tpu_torch import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.main([CORNELL, "--res", "8", "--reps", "1"])


def check_bench_line(out: str, want_keys):
    (line,) = out.strip().splitlines()
    rec = json.loads(line)
    assert want_keys <= set(rec)
    assert "vs_baseline" not in rec and "net_vs_baseline" not in rec
    assert rec["unit"] == "rays/s" and rec["card"] == "cpu"
    assert 0 < rec["net_rays_per_s"] <= rec["value"]
    assert 0 < rec["rays_net"] <= rec["rays_gross"]
    assert rec["best_s"] == min(rec["frame_s"]) <= rec["median_s"]
    return rec


JAX_KEYS = {"metric", "value", "unit", "net_rays_per_s", "card",
            "median_s", "best_s", "frame_s"}


def test_bench_line(capsys):
    from raytracer795_tpu_torch import bench

    rec = bench.bench_scene(res=16, spp=2, device="cpu")
    assert check_bench_line(capsys.readouterr().out, JAX_KEYS) == rec
    assert "Cornell path trace 16x16 2spp, depth 6" in rec["metric"]
    assert len(rec["frame_s"]) == bench.REPS


def test_bench_mesh_line(capsys):
    from raytracer795_tpu_torch import bench_mesh

    rec = bench_mesh.bench_scene("rock100k.xml", "rock100k", 16, 1,
                                 device="cpu")
    out = check_bench_line(capsys.readouterr().out,
                           JAX_KEYS | {"frame_seconds"})
    assert out == rec and rec["frame_seconds"] == rec["best_s"]
    assert "rock100k 101762 tris, Whitted 16x16 1spp, depth 2, 2 shadow " \
        "lights" in rec["metric"]
