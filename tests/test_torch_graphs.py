"""The captured programs' bodies (``utils/graphs.py``) against today's eager
bands, on the CPU, where a ``Graph`` runs its body on every call through
the same static buffers.

- A key may be a pair of 0-d int64 tensors, or a ``KeyTable`` row; its
  ``random_bits``, ``uniform`` and ``fold_in`` are the int key's and
  ``jax.random``'s bit for bit.
- ``render_camera(..., _graphs=True)`` equals the eager frame
  (``render_band``, ``render_sample_range``) bit for bit, float and LDR:
  cornellbox (Whitted, dielectric stacks), cornellbox_pt at 4 spp over
  one-row bands of two chunk sizes, a textured scene, the environment
  light, an image background, an area light and motion blur; the
  checkpoint kill and resume, ``count_net_rays`` and the band split of
  ``parallel/distributed.py`` through the programs.
- A second seed re-uses every program and equals the eager frame of that
  seed: the key, ``row0`` and ``base`` are inputs, not constants. A new
  resolution makes new programs.
- The bodies make no host sync (brute-path scenes): after a first frame
  has filled the caches, a frame whose bodies run with ``bool``,
  ``.item``, ``.cpu``, ``.tolist`` and numpy-to-tensor copies raising
  equals the eager frame.
- The hoisted copies: ``hit_details`` copies its primitive offsets once a
  scene, ``trace_anyhit`` fills a Python cap on the device.
- A launch recorded into a capture is counted on each replay, not at
  capture.
- Every graph hands out buffers of its own, made outside the pool it
  shares, so no result is memory a later capture may reuse.
"""

import contextlib
import dataclasses
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)


def _load(name, res=None, ny=None):
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(os.path.join(conftest.SCENES, name + ".xml"), "cpu")
    if res is not None:
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res,
                                            ny=ny or res)
    return ld


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key).view(np.uint32))


# ---- keys on the device ----


@pytest.mark.parametrize("shape", [(7,), (5, 6, 4)])
def test_tensor_key_draws_match_int_key_and_jax(shape):
    from raytracer795_tpu_torch.utils import rng

    host = rng.fold_in(rng.fold_in(rng.PRNGKey(21), 3), 1000)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(21), 3),
                            1000)
    tensor_key = tuple(torch.tensor(w, dtype=torch.int64) for w in host)
    table = rng.KeyTable("cpu")
    table.set_root(rng.PRNGKey(21))
    table_key = rng.fold_in(rng.fold_in(table.key(), 3), 1000)
    assert _words(jk) == host
    for key in (tensor_key, table_key):
        assert tuple(int(w) for w in key) == host
        folded = rng.fold_in(key, 7)
        assert tuple(int(w) for w in folded) == rng.fold_in(host, 7) \
            == _words(jax.random.fold_in(jk, 7))
        np.testing.assert_array_equal(
            rng.random_bits(key, shape, "cpu").numpy().astype(np.uint32),
            np.asarray(jax.random.bits(jk, shape)))
        np.testing.assert_array_equal(
            rng.uniform(key, shape, "cpu").numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))


def test_key_table_rows_follow_the_root():
    """Every row's words are rewritten for a new root; rows added past the
    first capacity keep their paths; a frozen table refuses a new path."""
    from raytracer795_tpu_torch.utils import rng

    table = rng.KeyTable("cpu", rows=2)
    keys = [rng.fold_in(rng.fold_in(table.key(), i), 2000 + i)
            for i in range(5)]
    assert table.words.shape[0] >= 11
    for seed in (0, 9):
        table.set_root(rng.PRNGKey(seed))
        for i in range(5):
            want = rng.fold_in(rng.fold_in(rng.PRNGKey(seed), i), 2000 + i)
            got = rng.fold_in(rng.fold_in(table.key(), i), 2000 + i)
            assert tuple(int(w) for w in got) == want
    assert keys[4].row == got.row
    table.freeze()
    rng.fold_in(table.key(), 4)             # a known path
    with pytest.raises(RuntimeError, match="warm-up did not derive"):
        rng.fold_in(table.key(), 5)


# ---- frames through the programs ----


FRAMES = [
    # scene, res (nx, ny), spp, MAX_LANES
    ("cornellbox", (32, 32), None, None),
    ("cornellbox_pt", (16, 8), 4, 48),      # one-row bands, chunks of 3, 1
    ("cornellbox_pt", (24, 24), 4, None),
    ("textures", (32, 32), None, None),
    ("envlight", (24, 24), 2, None),
    ("background", (32, 16), None, 256),    # two bands
    ("arealight", (24, 24), 2, None),
    ("motionblur", (24, 24), 3, 256),
]


@pytest.mark.parametrize("name,res,spp,lanes", FRAMES)
def test_programs_equal_eager_frames(name, res, spp, lanes, monkeypatch):
    from raytracer795_tpu_torch import render

    if lanes is not None:
        monkeypatch.setattr(render, "MAX_LANES", lanes)
    ld = _load(name, *res)
    for ldr in (False, True):
        want = render.render_camera(ld, 0, seed=5, spp=spp, ldr=ldr)
        got = render.render_camera(ld, 0, seed=5, spp=spp, ldr=ldr,
                                   _graphs=True)
        assert _same(got, want), (name, ldr)


def test_second_seed_reuses_programs(monkeypatch):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.utils import graphs

    monkeypatch.setattr(render, "MAX_LANES", 48)
    ld = _load("cornellbox_pt", 16, 8)
    render.render_camera(ld, 0, seed=1, spp=4, _graphs=True)
    progs = graphs.programs(ld.scene)
    made, bodies = len(progs.by_key), progs.captures()
    for seed in (2, 3):
        got = render.render_camera(ld, 0, seed=seed, spp=4, _graphs=True)
        assert (len(progs.by_key), progs.captures()) == (made, bodies)
        assert _same(got, render.render_camera(ld, 0, seed=seed, spp=4))
    assert not _same(got, render.render_camera(ld, 0, seed=2, spp=4))
    ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=8)
    render.render_camera(ld, 0, seed=2, spp=4, _graphs=True)
    assert len(progs.by_key) > made and progs.captures() > bodies


def test_checkpoint_resume_through_programs(tmp_path, monkeypatch):
    """Killed inside band 0 (1-row bands of two chunks) and resumed through
    the programs: the uninterrupted eager film bit for bit."""
    from raytracer795_tpu_torch import render

    monkeypatch.setattr(render, "MAX_LANES", 32)
    ld = _load("cornellbox", 16, 16)
    want = render.render_camera(ld, 0, seed=3, spp=4)
    path = str(tmp_path / "film.ckpt.npz")

    def run(abort):
        return render.render_camera(
            ld, 0, seed=3, spp=4,
            checkpoint=render.FilmCheckpoint(path, every_s=0.0),
            _abort_after_saves=abort, _graphs=True)
    with pytest.raises(KeyboardInterrupt):
        run(1)
    assert _same(run(None), want)


def test_net_rays_and_band_split_through_programs(monkeypatch):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.parallel import distributed

    monkeypatch.setattr(render, "MAX_LANES", 128)
    ld = _load("cornellbox_pt", 16, 16)
    assert render.count_net_rays(ld, 0, seed=4, spp=2, _graphs=True) \
        == render.count_net_rays(ld, 0, seed=4, spp=2)
    split = distributed._band_split([torch.device("cpu")] * 2, 0, 1)
    got = render.render_camera(ld, 0, seed=4, spp=2, _distribute=split,
                               _graphs=True)
    want = render.render_camera(ld, 0, seed=4, spp=2, _distribute=split)
    assert _same(got, want)


def test_every_graph_hands_out_buffers_of_its_own():
    """A graph's results are copied into buffers made outside the pool, the
    same tensors on every call; after a frame, every graph of the scene has
    them, the rays and film graphs included."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.utils import graphs

    x = torch.zeros(3)
    g = graphs.Graph(lambda: (x + 1, x * 2), graphs.Programs("cpu"))
    first = g()
    x += 1
    again = g()
    assert all(a is b for a, b in zip(first, again))
    assert again[0].tolist() == [2.0] * 3 and again[1].tolist() == [2.0] * 3
    ld = _load("cornellbox_pt", 16, 16)
    render.render_camera(ld, 0, seed=1, spp=2, ldr=True, _graphs=True)
    made = graphs.programs(ld.scene).graphs
    assert {g.name.split()[0] for g in made} >= {"rays", "film", "mean"}
    for g in made:
        assert isinstance(g.into, list) and g.into
        assert all(isinstance(t, torch.Tensor) for t in g.into)


# ---- no host sync inside a body ----


@contextlib.contextmanager
def _host_syncs_raise():
    def refuse(what):
        def call(*args, **kwargs):
            raise AssertionError(f"{what} inside a captured body")
        return call

    as_tensor = torch.as_tensor

    def no_numpy(data, *args, **kwargs):
        if isinstance(data, np.ndarray):
            raise AssertionError("torch.as_tensor(numpy) inside a body")
        return as_tensor(data, *args, **kwargs)
    with contextlib.ExitStack() as stack:
        for name in ("__bool__", "item", "cpu", "tolist"):
            stack.enter_context(mock.patch.object(
                torch.Tensor, name, refuse(name)))
        stack.enter_context(mock.patch.object(torch, "as_tensor", no_numpy))
        stack.enter_context(mock.patch.object(
            torch, "from_numpy", refuse("torch.from_numpy")))
        yield


@pytest.mark.parametrize("name,res,spp", [
    ("cornellbox", (24, 24), None),
    ("cornellbox_pt", (16, 16), 2),
    ("textures", (24, 24), None),
    ("envlight", (16, 16), 2),
])
def test_bodies_make_no_host_sync(name, res, spp, monkeypatch):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.utils import graphs

    ld = _load(name, *res)
    render.render_camera(ld, 0, seed=1, spp=spp, _graphs=True)   # warm-up
    run_body = graphs.Graph._run_body
    ran = []

    def guarded(self, *args):
        ran.append(self.name)
        with _host_syncs_raise():
            return run_body(self, *args)
    monkeypatch.setattr(graphs.Graph, "_run_body", guarded)
    got = render.render_camera(ld, 0, seed=2, spp=spp, ldr=True,
                               _graphs=True)
    monkeypatch.undo()
    assert any(n.startswith("rays") for n in ran) and \
        any(" step " in n for n in ran) and any("film" in n for n in ran)
    assert _same(got, render.render_camera(ld, 0, seed=2, spp=spp, ldr=True))


# ---- the hoisted host-to-device copies ----


def test_hit_details_copies_offsets_once():
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.ops import intersect

    ld = _load("cornellbox", 16, 16)
    scene = ld.scene
    rays = camera.primary_rays(ld.cameras[0], device="cpu")
    hit = intersect.trace(scene, rays)
    vn = intersect.compute_vertex_normals(scene)
    assert bool(hit.is_sphere.any()) and bool((~hit.is_sphere & hit.valid)
                                              .any())
    want = intersect.hit_details(scene, rays, hit, vn)
    with _host_syncs_raise():
        got = intersect.hit_details(scene, rays, hit, vn)
    for a, b in zip(want, got):
        for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (a, b))):
            x, y = (t if isinstance(t, torch.Tensor) else torch.stack(t)
                    for t in (x, y))
            assert torch.equal(x, y)


def test_trace_anyhit_fills_a_python_cap_on_the_device():
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.ops import intersect

    ld = _load("cornellbox", 16, 16)
    rays = camera.primary_rays(ld.cameras[0], device="cpu")
    want = intersect.trace_anyhit(ld.scene, rays,
                                  torch.full((256,), 2.5))
    with mock.patch.object(torch, "as_tensor",
                           side_effect=AssertionError("as_tensor")):
        got = intersect.trace_anyhit(ld.scene, rays, 2.5)
    assert torch.equal(got, want) and bool(got.any()) \
        and not bool(got.all())


# ---- launches counted on replay ----


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


def test_captured_launches_count_on_replay(monkeypatch):
    from raytracer795_tpu_torch.utils import graphs

    counts = {"nearest": 0, "anyhit": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="outside graphs.Graph"):
        graphs.count_launch(counts, "nearest")
    monkeypatch.setattr(graphs, "_TALLY", [])
    graphs.count_launch(counts, "nearest")
    graphs.count_launch(counts, "anyhit")
    graphs.count_launch(counts, "anyhit")
    assert counts == {"nearest": 0, "anyhit": 0}     # captured, not run
    g = graphs.Graph(lambda: (), graphs.Programs("cpu"))
    g.device = torch.device("cuda")
    g._graph, g._out, g.launches = _FakeGraph(), (), graphs._TALLY
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for _ in range(3):
        g()
    assert g._graph.replays == 3 and counts == {"nearest": 3, "anyhit": 6}
