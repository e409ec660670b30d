"""Captured programs: the counterpart of the JAX package's jitted band.

The JAX package compiles each band once (``jax.jit`` over
``_render_single`` and ``_render_sample_range``, render.py:115-148) with the
camera, the band's rows and the sample count static, and the key, ``row0``
and ``base`` traced, so every band and chunk of a frame replays one
program. The port's counterpart on CUDA is a ``torch.cuda.CUDAGraph``: a
``Graph`` records its body's kernels once and replays them with no host
launch each. What changes from call to call lives in device buffers the
body reads: the key words (``rng.KeyTable``), ``row0`` and ``base``, the
rays and the lanes' state.

- ``Graph(fn)``: the first call runs ``fn`` eagerly on a side stream (the
  warm-up fills the caches whose first fill synchronizes: the BVH node
  tables, the Perlin tables, the kernel build), freezes its key tables and
  captures ``fn``; every call after that replays the capture. The body's
  results are copied into buffers allocated outside the graphs' pool
  (``into``), the same each call. A capture that fails raises: there is
  no eager fallback. On a CPU device a ``Graph`` runs its body on every
  call, so the CPU tests run the same bodies through the same buffers.
- ``run_lanes``: an integrator's lane machine (start, one graph per
  iteration index, the ``live`` read between them) through the programs of
  its lane count. The host loop keeps the integrators' early exit: it reads
  the lanes' ``live`` flag after each replay, as the eager loop does.
- ``programs(scene)``: the programs of a scene, kept weakly on the
  ``Scene`` object (as the BVH node tables are): a new ``Scene`` (for
  example from ``scene_with_params``) gets new programs. The programs read
  the scene's tensors where they were at capture, so a tensor changed in
  place is seen by the next replay, as by the eager path; a scene whose
  tensors are replaced must be a new ``Scene``. The programs, their
  buffers and their pool last as long as the scene, as ``jax.jit`` keeps
  its compilations: every later frame of the scene replays them instead
  of capturing again.
- ``count_launch``: the traversal kernels' launch count, kept per graph at
  capture and added on every replay, so a graphed frame counts what an
  eager frame counts.

``render.render_camera`` runs its frames through the programs on CUDA
(``active()``); everything else runs eagerly, as before.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.weak import WeakIdKeyDictionary

from raytracer795_tpu_torch.ops.intersect import Rays
from raytracer795_tpu_torch.utils import rng
from raytracer795_tpu_torch.utils.vec3 import Vec3

_PROGRAMS = WeakIdKeyDictionary()
# (counts, name) of each launch recorded into the graph being captured
_TALLY: Optional[List] = None
# whether the frame being rendered runs through the programs
_ACTIVE = contextvars.ContextVar("graphs_active", default=False)
# each device's side stream: warm-ups and captures run there
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def count_launch(counts: Dict[str, int], name: str):
    """One launch of kernel ``name``, counted in ``counts`` now, or, while
    a graph is captured, on each replay of that graph."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if _TALLY is None:
            raise RuntimeError(f"{name} was captured outside graphs.Graph: "
                               "its replays would not be counted")
        _TALLY.append((counts, name))
    else:
        counts[name] += 1


@contextlib.contextmanager
def running(on: bool):
    """``active()`` is ``on`` while inside (in this thread or task)."""
    token = _ACTIVE.set(on)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    """Whether the integrators run their lane machines through programs."""
    return _ACTIVE.get()


class Programs:
    """A scene's captured programs on its device, by key, and the memory
    pool they share. Only a graph's temporaries live in the pool, and they
    are dead when its capture ends: every graph copies its results into
    buffers allocated outside the pool (``Graph``'s ``into``), and reads
    nothing of the pool but its own temporaries. So a later capture may
    reuse an earlier graph's temporaries, and the graphs may replay in any
    order."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.by_key: dict = {}
        self.graphs: List[Graph] = []

    def get(self, key, make: Callable):
        got = self.by_key.get(key)
        if got is None:
            got = self.by_key[key] = make()
        return got

    def captures(self) -> int:
        """Graphs captured so far (on the CPU: bodies that have run)."""
        return sum(g.captured for g in self.graphs)


def programs(scene) -> Programs:
    """The programs of ``scene`` (made on first use)."""
    got = _PROGRAMS.get(scene)
    if got is None:
        got = _PROGRAMS[scene] = Programs(scene.device)
    return got


def _copy_into(bufs, values):
    """``bufs[i] = values[i]``, in order. A value may be its own buffer (a
    state field a step leaves as it was), never another buffer, which an
    earlier copy could have overwritten."""
    ptrs = {b.data_ptr(): i for i, b in enumerate(bufs)}
    for i, (b, v) in enumerate(zip(bufs, values)):
        if ptrs.get(v.data_ptr(), i) != i:
            raise ValueError(f"output {i} is buffer {ptrs[v.data_ptr()]}")
        if v.data_ptr() != b.data_ptr():
            b.copy_(v)


class Graph:
    """One captured body: ``fn(*args)`` returns a flat tuple of tensors.

    ``into``: buffers the results are copied into (inside the capture) and
    that are returned in their place, allocated outside the pool; ``"own"``
    makes them (``empty_like`` of the warm-up's results). No result is
    handed out from the pool, where a later capture could reuse its
    memory. ``tables``: the ``KeyTable``s the body derives
    keys from, frozen before the capture. The first call warms up and
    captures; later calls replay and ignore their arguments, which must be
    the same scene and buffers.
    """

    def __init__(self, fn: Callable, programs: Programs, into="own",
                 tables=(), name: str = "graph"):
        self.fn = fn
        self.device = programs.device
        self.pool = programs.pool
        self.into = into
        self.tables = tables
        self.name = name
        self.captured = False
        self.launches: List = []
        self._graph = None
        self._out = None
        programs.graphs.append(self)

    def _run_body(self, *args):
        return tuple(self.fn(*args))

    def __call__(self, *args):
        if self.device.type != "cuda":
            out = self._run_body(*args)
            self.captured = True
            if isinstance(self.into, str):
                self.into = [torch.empty_like(v) for v in out]
            _copy_into(self.into, out)
            return tuple(self.into)
        with torch.cuda.device(self.device):
            if self._graph is None:
                self._capture(args)
            self._graph.replay()
        for counts, name in self.launches:
            counts[name] += 1
        return self._out

    def _capture(self, args):
        global _TALLY
        stream = torch.cuda.current_stream(self.device)
        side = _SIDE.get(self.device)
        if side is None:
            side = _SIDE[self.device] = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            warm = self._run_body(*args)
        stream.wait_stream(side)
        if isinstance(self.into, str):
            self.into = [torch.empty_like(v) for v in warm]
        del warm
        for table in self.tables:
            table.freeze()
        graph = torch.cuda.CUDAGraph()
        _TALLY = []
        # a graph the collector frees during the capture (another scene's
        # programs: their closures make cycles) would invalidate it, so
        # the collector runs before the capture (``torch.cuda.graph``
        # collects on entry) and not during it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                _copy_into(self.into, self._run_body(*args))
                out = tuple(self.into)
        except RuntimeError as e:
            raise RuntimeError(f"capturing the {self.name} graph failed: "
                               f"{e}") from e
        finally:
            tally, _TALLY = _TALLY, None
            if collecting:
                gc.enable()
        self._graph, self._out = graph, out
        self.launches = tally
        self.captured = True


def _tensors(tree):
    """The tensors of a tree of (named) tuples, and how to rebuild it (its
    None leaves, such as a state's absent counter, kept in place)."""
    leaves, spec = pytree.tree_flatten(tree)
    keep = [i for i, x in enumerate(leaves) if x is not None]
    return [leaves[i] for i in keep], (spec, keep, len(leaves))


def _rebuild(tensors, how):
    spec, keep, n = how
    leaves = [None] * n
    for i, t in zip(keep, tensors):
        leaves[i] = t
    return pytree.tree_unflatten(leaves, spec)


class _Lanes:
    """The programs of one lane machine at one lane count: input buffers,
    the start graph (state and vertex normals into own buffers), one graph
    per iteration index (state updated in place, ``live`` out) and the key
    table of each."""

    def __init__(self, progs: Programs, n: int):
        dev = progs.device
        # o.xyz, d.xyz, time, bg.xyz
        self.inputs = [torch.empty((n,), device=dev) for _ in range(10)]
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.start: Optional[Graph] = None
        self.steps: Dict[int, Graph] = {}
        self.spec = None


def run_lanes(scene, rays, bg, key, start, step, live, trips: int,
              with_stats: bool, name: str):
    """An integrator's lane machine through its programs.

    ``start(scene, rays, with_stats)`` gives (state, vertex normals);
    ``step(scene, time, bg, key, vertex normals, state, i)`` the next
    state; ``live(state)`` a 0-d bool, whether another step could add
    anything. Steps run while ``live`` is true, at most ``trips``. Returns
    (the final state in the program's buffers, the steps run, the last
    ``live``). The state's tensors are overwritten by the next run: copy
    what must outlive it.
    """
    progs = programs(scene)
    n = rays.time.shape[0]
    lanes = progs.get((name, n, with_stats), lambda: _Lanes(progs, n))
    src = (*rays.o, *rays.d, rays.time, *bg)
    for buf, x in zip(lanes.inputs, src):
        if x is not buf:
            buf.copy_(x)
    o = Vec3(*lanes.inputs[0:3])
    d = Vec3(*lanes.inputs[3:6])
    time = lanes.inputs[6]
    bgv = Vec3(*lanes.inputs[7:10])

    if lanes.start is None:
        def start_body(sc):
            state, vn = start(sc, Rays(o=o, d=d, time=time), with_stats)
            leaves, lanes.spec = _tensors(state)
            return (*leaves, vn)
        lanes.start = Graph(start_body, progs, name=f"{name} start")
    out = lanes.start(scene)
    state_bufs, vn = list(out[:-1]), out[-1]

    def step_graph(i):
        table = rng.KeyTable(progs.device)

        def body(sc):
            state = _rebuild(state_bufs, lanes.spec)
            new = step(sc, time, bgv, table.key(), vn, state, i)
            leaves, _ = _tensors(new)
            return (*leaves, live(new))
        return Graph(body, progs, into=[*state_bufs, lanes.live],
                     tables=(table,), name=f"{name} step {i}")

    i, still = 0, True
    while i < trips and still:
        g = lanes.steps.get(i)
        if g is None:
            g = lanes.steps[i] = step_graph(i)
        g.tables[0].set_root(key)
        g(scene)
        nxt = lanes.steps.get(i + 1)
        if nxt is not None:
            nxt.tables[0].set_root(key)     # host work while the card runs
        still = bool(lanes.live)
        i += 1
    return _rebuild(state_bufs, lanes.spec), i, still
