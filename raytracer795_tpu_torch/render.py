"""Render entry points + CLI: scene in, images out.

Counterpart of ``raytracer795_tpu/render.py``. Frames tile into row bands
of at most ``MAX_LANES`` lanes (a band's samples included), lanes come in
the tile-swizzled order of ``camera.band_pixels``, and each band is
quantized to LDR on the device before it crosses to the host.

A 1-spp frame traces center-of-pixel rays with key ``PRNGKey(seed)``. A
multi-sample frame renders each band in chunks of samples: chunk
``[done, done + s)`` draws from ``fold_in(PRNGKey(seed), done)``, folded
again with the band's first row when the band is narrower than the frame,
and the band's film accumulates ``mean * s`` on the device, as the JAX
package does, so a frame equals the JAX render of the same seed.

``FilmCheckpoint`` saves the film at band (1 spp) or sample-chunk
(multi-spp) boundaries in the JAX package's npz layout; a killed render
resumes from it bit for bit, and a checkpoint written by either package
resumes in the other. Cameras with a ``<Tonemap>`` get ``reinhard_global``
before their PNG or PPM is written; other names are written as half-float
EXR.

On a CUDA device every band runs through captured programs
(``utils/graphs.py``), the counterpart of the JAX package's jitted band
functions: the camera, the band's rows and the sample count are static and
the key, ``row0`` and ``base`` are device inputs, so each band shape
captures its graphs once (the rays and background, each iteration or
bounce of the integrator, the tail) and every later band, chunk and frame
replays them. The graphs replay the eager path's kernels, so a frame has
the same bits either way. The CPU renders op by op.

Frames build no autograd graph: ``render_band`` and
``render_sample_range`` run under ``torch.no_grad()``, while the
integrators themselves are differentiable (``parallel/shard.py`` takes
their gradients).

``count_net_rays`` counts the rays a frame's live lanes trace (the JAX
package's survivor-weighted "net" count) by rendering the frame once more
through the same schedule; ``log_render_stats`` reports it beside the gross
count.

CLI::

    python -m raytracer795_tpu_torch.render scene.xml [-o OUTDIR]
        [--device cuda] [--spp N] [--seed N]
        [--checkpoint-dir DIR] [--checkpoint-every SECONDS]

``--device`` defaults to ``cuda``; without a CUDA device the CLI raises
instead of rendering on the CPU. ``--device cpu`` renders on the CPU.
With ``--checkpoint-dir`` each camera saves ``<ImageName>.ckpt.npz`` (and a
preview PNG beside it) at most every ``--checkpoint-every`` seconds; running
the same command again resumes, and a finished checkpoint renders nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time as _time

import numpy as np
import torch

from raytracer795_tpu_torch.models import camera as camera_model
from raytracer795_tpu_torch.models import lights, path_tracer, whitted
from raytracer795_tpu_torch.ops import bvh_traverse, intersect
from raytracer795_tpu_torch.ops.texture import sample_image
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.loader import load_scene
from raytracer795_tpu_torch.utils import graphs, image_io, rng
from raytracer795_tpu_torch.utils.tonemap import reinhard_global
from raytracer795_tpu_torch.utils.vec3 import Vec3, cdiv

# Max lanes per band (the JAX package's budget; not yet retuned for the
# card). On CUDA it is also the lane count of the band's graphs: the
# integrators' lane state, and so their programs' memory, scale with it.
MAX_LANES = 1 << 18


def _integrator(scene: T.Scene, with_stats: bool = False):
    """The scene's integrator; with stats it returns (radiance, net)."""
    if scene.renderer == "pathtracing":
        return functools.partial(path_tracer.render_rays,
                                 with_stats=with_stats)
    return functools.partial(whitted.render_rays, with_stats=with_stats)


def band_rows(cam: T.Camera) -> int:
    """Rows per band: as many as fit MAX_LANES with all of a pixel's
    samples, rounded down to a multiple of the swizzle tile height when
    the frame needs several bands (the JAX package's render.py:355-358)."""
    total = max(1, cam.num_samples)
    band = min(cam.ny, max(1, MAX_LANES // (cam.nx * total)))
    if band < cam.ny and band > camera_model.TILE_H:
        band -= band % camera_model.TILE_H
    return band


def _background_radiance(scene: T.Scene, cam: T.Camera,
                         rays: intersect.Rays, px: torch.Tensor,
                         py: torch.Tensor, count: int = 0) -> Vec3:
    """Per-ray miss radiance (Scene::GetBackgroundColor,
    src/Scene.cpp:413-435): the environment light's lookup along the ray,
    the background texture at the lane's pixel (px / nx, py / ny), or the
    constant background color.

    ``count`` 0 is a 1-spp band, one lane a pixel; it keeps the reference's
    quirk of sampling the background texture with u and v swapped, since
    SingleSample passes (x, y) into (row, col) parameters
    (src/Scene.cpp:365-384 vs :431-432). ``count`` > 0 is a multi-sample
    band, each pixel's uv repeated over its ``count`` lanes, oriented
    normally.
    """
    if scene.env_texture >= 0:
        return lights.env_radiance(scene, rays.d)
    if scene.bg_texture >= 0:
        pu = cdiv(px.to(torch.float32), cam.nx)
        pv = cdiv(py.to(torch.float32), cam.ny)
        if count:
            pu = pu.repeat_interleave(count)
            pv = pv.repeat_interleave(count)
        else:
            pu, pv = pv, pu
        return sample_image(scene.textures[scene.bg_texture], pu, pv)
    n = rays.time.shape[0]
    bg = scene.background
    return Vec3(bg[0].expand(n), bg[1].expand(n), bg[2].expand(n))


def _band_rays(scene: T.Scene, cam: T.Camera, px: torch.Tensor,
               py: torch.Tensor, key=None, base=0, count: int = 0):
    """Rays and miss radiance of a band's lanes at pixels (px, py):
    center-of-pixel rays (``count`` 0), or samples [base, base + count) of
    each pixel jittered from ``key``."""
    if count:
        rays = camera_model.sample_rays_at(cam, key, px, py, base, count)
    else:
        rays = camera_model.primary_rays_at(cam, px, py)
    return rays, _background_radiance(scene, cam, rays, px, py, count)


def _band_key(cam: T.Camera, rows: int, key, row0: int):
    """The key a band's samples draw from: ``key`` folded with ``row0``
    when the frame has several bands (decorrelating them); a full frame
    keeps the stream."""
    return rng.fold_in(key, row0) if rows < cam.ny else key


def _sample_sums(out: torch.Tensor, count: int) -> torch.Tensor:
    """Lane-ordered samples [N * count, 3] -> each pixel's sum [N, 3], its
    samples added in order."""
    out = out.reshape(-1, count, 3)
    acc = out[:, 0]
    for k in range(1, count):
        acc = acc + out[:, k]
    return acc


def _film_values(x: torch.Tensor, total: int, ldr: bool) -> torch.Tensor:
    """A band's film values: ``x`` over ``total`` (a mean of sums above 1
    spp), LDR-quantized with ``ldr``."""
    if total > 1:
        x = cdiv(x, total)
    if ldr:
        x = torch.clamp(x, 0.0, 255.0).to(torch.uint8)
    return x


def _unswizzled(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Lane-ordered values -> row-major pixel order."""
    flat = torch.empty_like(x)
    flat[idx] = x
    return flat


@torch.no_grad()
def render_band(scene: T.Scene, cam: T.Camera, px: torch.Tensor,
                py: torch.Tensor, key: rng.Key, integrate=None
                ) -> torch.Tensor:
    """Radiance [N, 3] of per-lane frame pixels (px, py): center-of-pixel
    rays (src/Scene.cpp:365-384) through the scene's integrator, or
    through ``integrate(scene, rays, bg, key)`` when given."""
    rays, bg = _band_rays(scene, cam, px, py)
    return (integrate or _integrator(scene))(scene, rays, bg, key)


@torch.no_grad()
def render_sample_range(scene: T.Scene, cam: T.Camera, key: rng.Key,
                        base: int, count: int, row0: int, rows: int,
                        px: torch.Tensor, py_rel: torch.Tensor,
                        integrate=None) -> torch.Tensor:
    """Mean radiance [N, 3] over jittered samples [base, base + count) of a
    band's per-lane pixels (px, row0 + py_rel), in lane order, through the
    scene's integrator or ``integrate``."""
    key = _band_key(cam, rows, key, row0)
    rays, bg = _band_rays(scene, cam, px, row0 + py_rel, key, base, count)
    out = (integrate or _integrator(scene))(scene, rays, bg, key)
    return cdiv(_sample_sums(out, count), count)


def with_spp(cam: T.Camera, spp: int | None) -> T.Camera:
    """The camera with ``spp`` samples and its jitter grid (the smallest g
    with g * g >= spp), or the camera itself for ``spp=None``."""
    if spp is None or spp == cam.num_samples:
        return cam
    g = 1
    while g * g < spp:
        g += 1
    return dataclasses.replace(cam, num_samples=spp, grid=g)


class FilmCheckpoint:
    """Film checkpoint and resume for long renders (the reference writes
    its film only at the end, src/Scene.cpp:361).

    A render is a pure function of (scene, camera, seed): band and chunk
    boundaries are fixed and chunk ``done`` draws from ``fold_in(key,
    done)``. A checkpoint holds the film's raw sums at a band or chunk
    boundary, so resuming replays the remaining chunks and gives the
    uninterrupted film bit for bit. The npz layout (``state_key``,
    ``film_sum``, ``sample_count``, ``row0``) and the state key are the JAX
    package's. Every save also writes ``<path>.preview.png``, the partial
    film over its sample counts.
    """

    def __init__(self, path: str, every_s: float = 30.0):
        self.path = path
        self.every_s = every_s
        self._last = 0.0

    def _state_key(self, cam: T.Camera, seed: int) -> str:
        return f"{cam.cam_id}:{cam.nx}x{cam.ny}:{cam.num_samples}:{seed}"

    def load(self, cam: T.Camera, seed: int):
        """(film_sum, sample_count, row0) of a checkpoint of this render,
        or None when there is none or it belongs to another render."""
        if not os.path.exists(self.path):
            return None
        data = np.load(self.path, allow_pickle=False)
        if str(data["state_key"]) != self._state_key(cam, seed):
            return None
        return (data["film_sum"].copy(), data["sample_count"].copy(),
                int(data["row0"]))

    def due(self) -> bool:
        """Whether a save now would pass the time gate. The render asks
        this before it pulls a band's accumulator to the host, so the
        chunks between saves run without a host sync."""
        return _time.monotonic() - self._last >= self.every_s

    def save(self, cam, seed, film_sum, sample_count, row0,
             force=False) -> bool:
        now = _time.monotonic()
        if not force and now - self._last < self.every_s:
            return False
        self._last = now
        tmp = self.path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, state_key=self._state_key(cam, seed),
                     film_sum=film_sum, sample_count=sample_count,
                     row0=np.int64(row0))
        os.replace(tmp, self.path)
        cnt = np.maximum(sample_count, 1)[..., None]
        image_io.save_image(self.path + ".preview.png", film_sum / cnt)
        return True


def _film_rows(x: torch.Tensor, idx: torch.Tensor, rows: int, nx: int):
    """Lane-ordered [rows * nx, 3] -> [rows, nx, 3] on the host."""
    return _unswizzled(x, idx).cpu().numpy().reshape(rows, nx, 3)


class _EagerBand:
    """A band rendered op by op: the CPU path, and CUDA with
    ``render_camera(..., _graphs=False)``."""

    def __init__(self, scene: T.Scene, cam: T.Camera, rows: int):
        self.cam, self.rows = cam, rows
        self.px, self.py_rel = camera_model.band_pixels(cam.nx, rows,
                                                        scene.device)
        self.idx = camera_model.band_unswizzle_index(self.px, self.py_rel,
                                                     cam.nx)

    def single(self, scene, row0, key, integrate):
        """The band's 1-spp radiance [N, 3] in lane order."""
        return render_band(scene, self.cam, self.px, row0 + self.py_rel,
                           key, integrate)

    def sums(self, scene, film_sums):
        """The band's sample sums in lane order: 0, or the film's."""
        if film_sums is None:
            return torch.zeros((self.px.shape[0], 3), device=scene.device)
        return torch.from_numpy(film_sums.reshape(-1, 3)).to(
            scene.device)[self.idx]

    def chunk(self, scene, acc, key, done, s, row0, integrate):
        """``acc`` plus the mean of samples ``[done, done + s)`` times
        ``s``, drawn as ``render_sample_range`` draws them from ``key``."""
        img = render_sample_range(scene, self.cam, key, done, s, row0,
                                  self.rows, self.px, self.py_rel, integrate)
        return acc + img * float(s)

    def film(self, x, total: int, ldr: bool):
        """The band's film rows on the host (``_film_values`` of ``x``)."""
        return _film_rows(_film_values(x, total, ldr), self.idx, self.rows,
                          self.cam.nx)


class _GraphedBand(_EagerBand):
    """A band through its captured programs (utils/graphs.py): the JAX
    package's jitted band functions with ``cam`` and ``n_rows`` static. The
    rays and background graph of each sample count reads the key table,
    ``row0`` and ``base``; the integrator runs through its own programs;
    the tail graphs take the chunk's mean into the band's sums and the
    film's division, quantization and unswizzle. Each step is the eager
    band's own function (``_band_rays``, ``_sample_sums``,
    ``_film_values``), and every output lands in a buffer of its own."""

    def __init__(self, progs: graphs.Programs, scene, cam, rows: int):
        super().__init__(scene, cam, rows)
        dev = scene.device
        n = self.px.shape[0]
        self.progs = progs
        self.row0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.base = torch.zeros((), dtype=torch.int64, device=dev)
        self.keys = rng.KeyTable(dev)
        self.out = torch.empty((n, 3), device=dev)     # the 1-spp radiance
        self.acc = torch.empty((n, 3), device=dev)     # the sample sums
        self.samples = {}   # count -> radiance [n * count, 3], lane order
        self.rays = {}      # count (0: 1 spp) -> Graph
        self.means = {}     # count -> Graph
        self.ends = {}      # (total, ldr) -> Graph

    def _rays(self, scene, count: int):
        """Rays and background of the band (``render_band``'s or
        ``render_sample_range``'s, up to the integrator)."""
        g = self.rays.get(count)
        if g is None:
            def body(sc):
                rays, bg = _band_rays(
                    sc, self.cam, self.px, self.row0 + self.py_rel,
                    self.keys.key() if count else None, self.base, count)
                return (*rays.o, *rays.d, rays.time, *bg)
            g = self.rays[count] = graphs.Graph(
                body, self.progs, tables=(self.keys,) if count else (),
                name=f"rays x{count}")
        out = g(scene)
        return (intersect.Rays(o=Vec3(*out[0:3]), d=Vec3(*out[3:6]),
                               time=out[6]), Vec3(*out[7:10]))

    def single(self, scene, row0, key, integrate):
        self.row0.fill_(row0)
        rays, bg = self._rays(scene, 0)
        self.out.copy_((integrate or _integrator(scene))(scene, rays, bg,
                                                         key))
        return self.out

    def sums(self, scene, film_sums):
        if film_sums is None:
            self.acc.zero_()
        else:
            self.acc.copy_(super().sums(scene, film_sums))
        return self.acc

    def chunk(self, scene, acc, key, done, s, row0, integrate):
        key = _band_key(self.cam, self.rows, key, row0)
        self.row0.fill_(row0)
        self.base.fill_(done)
        self.keys.set_root(key)
        rays, bg = self._rays(scene, s)
        out = (integrate or _integrator(scene))(scene, rays, bg, key)
        buf = self.samples.get(s)
        if buf is None:
            buf = self.samples[s] = torch.empty_like(out)
        buf.copy_(out)
        g = self.means.get(s)
        if g is None:
            def body(sc):
                return (self.acc + cdiv(_sample_sums(buf, s), s) * float(s),)
            g = self.means[s] = graphs.Graph(body, self.progs,
                                             into=[self.acc],
                                             name=f"mean x{s}")
        g(scene)
        return self.acc

    def film(self, x, total: int, ldr: bool):
        g = self.ends.get((total, ldr))
        if g is None:
            src = self.acc if total > 1 else self.out

            def body():
                return (_unswizzled(_film_values(src, total, ldr), self.idx),)
            g = self.ends[(total, ldr)] = graphs.Graph(
                body, self.progs, name=f"film /{total} ldr={ldr}")
        flat, = g()
        return flat.cpu().numpy().reshape(self.rows, self.cam.nx, 3)


def _cam_key(cam: T.Camera) -> tuple:
    """The camera's fields, hashable: what a band's graphs bake in."""
    return tuple(v.tobytes() if isinstance(v, np.ndarray) else v
                 for v in dataclasses.astuple(cam))


def render_camera(loaded: T.LoadedScene, cam_index: int = 0, seed: int = 0,
                  spp: int | None = None, ldr: bool = False,
                  checkpoint: FilmCheckpoint | None = None,
                  _abort_after_saves: int | None = None,
                  _distribute=None, _graphs: bool | None = None
                  ) -> np.ndarray:
    """Render one camera to a [ny, nx, 3] image on the host.

    Float32 radiance, or with ``ldr=True`` uint8 quantized on the device:
    clamp to [0, 255] and truncate, bitwise what ``to_ldr`` of the float
    image gives (src/Image.cpp:64-69). ``spp`` overrides the camera's
    NumSamples. Each band is traced in tile-swizzled lane order and put
    back in row order on the device.

    ``checkpoint`` saves the film at band boundaries (1 spp) or chunk
    boundaries (multi-spp) and resumes from a checkpoint of the same
    render; it renders on the float path (``ldr`` is ignored).
    ``_abort_after_saves`` raises ``KeyboardInterrupt`` after that many
    saves (a kill, for tests). ``_distribute`` is ``(owns, integrate)``
    from ``parallel/distributed.py`` or ``count_net_rays``: bands whose
    index ``owns`` refuses (none when it is None) stay 0 and launch
    nothing, and ``integrate(scene, rays, bg, key)`` replaces the scene's
    integrator. ``_graphs`` runs the bands through their captured programs
    (True), or op by op (False); None, the default, is True on CUDA and
    False elsewhere. A CPU device runs the programs' bodies eagerly.
    """
    scene = loaded.scene
    if _graphs is None:
        _graphs = scene.device.type == "cuda"
    with graphs.running(_graphs):
        return _render_camera(loaded, cam_index, seed, spp, ldr, checkpoint,
                              _abort_after_saves, _distribute, _graphs)


@torch.no_grad()
def _render_camera(loaded, cam_index, seed, spp, ldr, checkpoint,
                   abort_after_saves, distribute, graphed):
    scene = loaded.scene
    cam = with_spp(loaded.cameras[cam_index], spp)
    key = rng.PRNGKey(seed)
    total = max(1, cam.num_samples)
    band = band_rows(cam)
    chunk = max(1, MAX_LANES // (cam.nx * band))
    owns, integrate = distribute or (None, None)
    ldr = ldr and checkpoint is None and distribute is None
    # with a checkpoint above 1 spp, ``film`` holds the sample sums (the
    # npz's film_sum) until the division at the end
    film = np.zeros((cam.ny, cam.nx, 3), np.uint8 if ldr else np.float32)
    counts = np.zeros((cam.ny, cam.nx), np.int64)
    start_row, saves = 0, 0
    if checkpoint is not None:
        got = checkpoint.load(cam, seed)
        if got is not None:
            film, counts, start_row = got
    progs = graphs.programs(scene) if graphed else None

    def save(next_row0):
        nonlocal saves
        if checkpoint.save(cam, seed, film, counts, next_row0):
            saves += 1
            if abort_after_saves is not None \
                    and saves >= abort_after_saves:
                raise KeyboardInterrupt("render aborted by test hook")

    for row0 in range(start_row, cam.ny, band):
        if owns is not None and not owns(row0 // band):
            continue
        rows = min(band, cam.ny - row0)
        sl = slice(row0, row0 + rows)
        runner = (progs.get(("band", _cam_key(cam), rows),
                            lambda: _GraphedBand(progs, scene, cam, rows))
                  if graphed else _EagerBand(scene, cam, rows))

        if total == 1:
            out = runner.single(scene, row0, key, integrate)
            if checkpoint is not None:
                film[sl] = runner.film(out, 1, False)
                counts[sl] = 1
                if checkpoint.due() or row0 + rows >= cam.ny:
                    save(row0 + rows)
                continue
        else:
            # the band's sums in lane order, restored from a checkpoint
            # that stopped inside it; the add order stays acc + img * s
            done = int(counts[sl].max())
            out = runner.sums(scene, film[sl] if done else None)
            while done < total:
                s = min(chunk, total - done)
                out = runner.chunk(scene, out, rng.fold_in(key, done), done,
                                   s, row0, integrate)
                done += s
                if checkpoint is not None and (checkpoint.due()
                                               or done >= total):
                    film[sl] = _film_rows(out, runner.idx, rows, cam.nx)
                    counts[sl] = done
                    save(row0 + band if done >= total else row0)
            if checkpoint is not None:
                continue
        film[sl] = runner.film(out, total, ldr)
    if checkpoint is None:
        return film
    checkpoint.save(cam, seed, film, counts, cam.ny, force=True)
    return film if total == 1 else film / np.float32(total)


def count_net_rays(loaded: T.LoadedScene, cam_index: int = 0,
                   seed: int = 0, spp: int | None = None,
                   _graphs: bool | None = None) -> int:
    """Rays the live lanes of a frame trace (the JAX package's
    ``count_net_rays``): extension rays of the lanes still active at each
    iteration or bounce, plus the shadow rays of the lanes shaded. The
    gross count bills every lane for the full depth; this one does not.

    It renders the frame once more through ``render_camera``, with an
    integrator that also counts, so bands, sample chunks and keys are the
    frame's own; its one host read is the final sum. Call it outside a
    timed region. ``_graphs`` is ``render_camera``'s.
    """
    counted = _integrator(loaded.scene, with_stats=True)
    nets = []

    def integrate(scene, rays, bg, key):
        radiance, net = counted(scene, rays, bg, key)
        nets.append(net)
        return radiance
    render_camera(loaded, cam_index, seed=seed, spp=spp,
                  _distribute=(None, integrate), _graphs=_graphs)
    return int(torch.stack(nets).sum())


def scene_stats(scene: T.Scene) -> dict:
    """Primitive counts, BVH shape and the traversal tables' bytes; the
    ``lights`` that trace shadow rays count the environment light, as the
    JAX package's do."""
    tris = sum(g.n_tris for g in scene.groups)
    spheres = sum(g.n_spheres for g in scene.groups)
    nodes = 0
    table_bytes = 0
    shared = set()
    for g in scene.groups:
        flats = (g.bvh,) if g.bvh is not None else g.pack_bvhs or ()
        nodes += sum(int(f.first.shape[0]) for f in flats)
        # groups of one pack_share id share their tables
        if flats and (g.pack_share < 0 or g.pack_share not in shared):
            shared.add(g.pack_share)
            table_bytes += bvh_traverse.table_nbytes(g)
    return {
        "renderer": scene.renderer, "max_depth": int(scene.max_depth),
        "tris": int(tris), "spheres": int(spheres),
        "groups": len(scene.groups), "bvh_nodes": int(nodes),
        "packs": sum(len(g.pack_bvhs or ()) for g in scene.groups),
        "traverse_table_mb": round(table_bytes / 1e6, 2),
        "lights": whitted.n_shadow_lights(scene),
        "object_lights": len(scene.sphere_lights) + len(scene.mesh_lights),
        "textures": int(scene.n_textures),
    }


def gross_rays(scene: T.Scene, cam: T.Camera) -> int:
    """Rays a frame in the JAX package's bench accounting (bench.py:47-56):
    every lane traces max_depth bounces of 1 extension ray plus 1
    occlusion ray per light (the environment light included), and, in the
    path tracer with NEE, 1 per object light."""
    st = scene_stats(scene)
    shadow = st["lights"]
    if scene.renderer == "pathtracing" and scene.pt_nee:
        shadow += st["object_lights"]
    lanes = cam.nx * cam.ny * max(1, cam.num_samples)
    return lanes * st["max_depth"] * (1 + shadow)


def log_render_stats(scene: T.Scene, cam: T.Camera, seconds: float,
                     stream=None, net_rays: int | None = None) -> dict:
    """Emit ONE JSON line per render to stderr, naming the device.

    ``rays`` and ``rays_per_s`` are the JAX package's log line's
    (its render.py:528-538): lanes x max_depth x (1 + lights), the
    environment light counted and object lights not; ``gross_rays_per_s``
    is ``gross_rays``, the bench accounting. ``net_rays`` (from
    ``count_net_rays``) adds ``rays_net`` and ``rays_net_per_s``, as the
    JAX line does."""
    dev = scene.device
    st = scene_stats(scene)
    rays = cam.nx * cam.ny * max(1, cam.num_samples) * st["max_depth"] \
        * (1 + st["lights"])
    rec = {
        "event": "render", "image": cam.image_name,
        "res": [cam.nx, cam.ny], "spp": max(1, cam.num_samples),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "seconds": seconds,
        "rays": rays,
        "rays_per_s": round(rays / max(seconds, 1e-9), 1),
        "gross_rays_per_s": gross_rays(scene, cam) / max(seconds, 1e-9),
        **st,
    }
    if net_rays is not None:
        rec["rays_net"] = int(net_rays)
        rec["rays_net_per_s"] = round(net_rays / max(seconds, 1e-9), 1)
    print(json.dumps(rec), file=stream or sys.stderr)
    return rec


def render_scene(loaded: T.LoadedScene, out_dir: str = ".", seed: int = 0,
                 spp: int | None = None, checkpoint_dir: str | None = None,
                 checkpoint_every_s: float = 30.0) -> list:
    """Render every camera and write its image (src/Scene.cpp:330-362).

    ``checkpoint_dir`` gives each camera a ``FilmCheckpoint`` there,
    ``<ImageName>.ckpt.npz``, resumed when it matches. A PNG or PPM camera
    with a ``<Tonemap>`` is written as ``reinhard_global`` of its float
    film; without one, and without checkpoints, its frame is quantized on
    the device. Other names are written as EXR.
    """
    paths = []
    for i, cam in enumerate(loaded.cameras):
        ckpt = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            ckpt = FilmCheckpoint(
                os.path.join(checkpoint_dir, f"{cam.image_name}.ckpt.npz"),
                every_s=checkpoint_every_s)
        lower = cam.image_name.lower()
        ldr_name = ".png" in lower or ".ppm" in lower
        t0 = _time.perf_counter()
        img = render_camera(loaded, i, seed=seed, spp=spp, checkpoint=ckpt,
                            ldr=ldr_name and cam.tonemap is None)
        dt = _time.perf_counter() - t0
        if cam.tonemap is not None and ldr_name:
            key_v, burn, sat, gamma = cam.tonemap
            img = reinhard_global(img, key=key_v, burn_percent=burn,
                                  saturation=sat, gamma=gamma)
        path = os.path.join(out_dir, cam.image_name)
        image_io.save_image(path, img)
        cam = with_spp(cam, spp)
        print(f"[raytracer795_tpu_torch] {cam.image_name}: "
              f"{cam.nx}x{cam.ny} spp={max(1, cam.num_samples)} in {dt:.3f}s")
        log_render_stats(loaded.scene, cam, dt)
        paths.append(path)
    return paths


def cli_device(name: str) -> torch.device:
    """A command line's ``--device``; "cuda" without a CUDA device raises
    rather than running on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}, but CUDA is not available; pass --device cpu "
            "to run on the CPU")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description="ray tracer on PyTorch and CUDA")
    ap.add_argument("scene", help="scene XML file (reference contract)")
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    ap.add_argument("--spp", type=int, default=None,
                    help="override NumSamples for every camera")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="film checkpoints and previews; running again "
                         "resumes")
    ap.add_argument("--checkpoint-every", type=float, default=30.0,
                    help="seconds between checkpoint saves")
    args = ap.parse_args(argv)
    loaded = load_scene(args.scene, cli_device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    render_scene(loaded, args.out_dir, seed=args.seed, spp=args.spp,
                 checkpoint_dir=args.checkpoint_dir,
                 checkpoint_every_s=args.checkpoint_every)


if __name__ == "__main__":
    main()
