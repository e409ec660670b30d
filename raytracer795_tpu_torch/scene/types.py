"""Scene data model: plain dataclasses of tensors.

Counterpart of ``raytracer795_tpu/scene/types.py``. The JAX package keeps
the scene as a pytree with static metadata; here the same fields are plain
dataclasses whose array leaves are torch tensors on one device, and whose
structural facts (counts, flags) are Python values. The TPU table layouts
of that package (``bvh_pack``, ``pack_bvhs``, ``pack_share``) have no
counterpart: the CUDA kernels build their tables from ``FlatBVH`` and the
live vertices (ops/bvh_traverse.py).

Index conventions: all indices are 0-based (the loader converts the XML's
1-based ones once).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

# Material types (src/Material.h:7)
MAT_NORMAL, MAT_MIRROR, MAT_CONDUCTOR, MAT_DIELECTRIC = 0, 1, 2, 3
# BRDF types (src/Material.h:8)
BRDF_NONE, BRDF_OBP, BRDF_MBP, BRDF_MBPN, BRDF_OP, BRDF_MP, BRDF_MPN, \
    BRDF_TS, BRDF_TSF = range(9)
# Decal modes (src/defs.h:8)
DECAL_REPLACE_KD, DECAL_BLEND_KD, DECAL_BUMP_NORMAL, DECAL_REPLACE_NORMAL, \
    DECAL_REPLACE_ALL, DECAL_REPLACE_BACKGROUND, DECAL_NONE = range(7)
# Interpolation (src/defs.h:9)
INTERP_NN, INTERP_BILINEAR = 0, 1
# Texture types (src/defs.h:10)
TEX_IMAGE, TEX_PERLIN = 0, 1
# Noise conversion (src/defs.h:11)
NC_ABSVAL, NC_LINEAR, NC_NONE = 0, 1, 2


@dataclasses.dataclass
class Materials:
    """SoA material table, one row per material id (src/Material.h:10-33)."""

    ambient: Any        # [M, 3]
    diffuse: Any        # [M, 3]
    specular: Any       # [M, 3]
    mirror: Any         # [M, 3]
    phong: Any          # [M]
    refraction: Any     # [M]
    absorption_index: Any   # [M]
    absorption_coef: Any    # [M, 3]
    roughness: Any      # [M]
    is_rough: Any       # [M] bool
    mtype: Any          # [M] int32 (MAT_*)
    brdf: Any           # [M] int32 (BRDF_*)


@dataclasses.dataclass
class Lights:
    """SoA light tables per type (src/Light.h, src/Parser.h:1197-1315)."""

    ambient: Any        # [3]
    point_pos: Any      # [P, 3]
    point_intensity: Any    # [P, 3]
    dir_dir: Any        # [D, 3] normalized
    dir_radiance: Any   # [D, 3]
    spot_pos: Any       # [S, 3]
    spot_dir: Any       # [S, 3] normalized
    spot_intensity: Any  # [S, 3]
    spot_coverage: Any  # [S] half-angle, radians
    spot_falloff: Any   # [S] half-angle, radians
    area_pos: Any       # [A, 3]
    area_normal: Any    # [A, 3] normalized
    area_u: Any         # [A, 3]
    area_v: Any         # [A, 3]
    area_radiance: Any  # [A, 3]
    area_size: Any      # [A]


@dataclasses.dataclass
class Texture:
    """One texture map (src/Texture.h:13-51); sampling is not ported yet."""

    image: Any          # [H, W, 3] f32
    normalizer: Any     # scalar
    bump_factor: Any    # scalar
    noise_scale: Any    # scalar
    decal: int
    interp: int
    ttype: int
    nc: int


@dataclasses.dataclass
class FlatBVH:
    """DFS-ordered flat BVH with skip links (built by ops/bvh.py).

    Stackless traversal: hit inner node i -> i+1; otherwise -> miss[i];
    leaves test primitive rows [first, first+count), count <= max_leaf.
    The group's primitive SoA is stored in leaf-contiguous order.
    """

    bmin: Any       # [M, 3] f32
    bmax: Any       # [M, 3] f32
    first: Any      # [M] i32 (leaves; 0 for inner)
    count: Any      # [M] i32 (0 = inner node)
    miss: Any       # [M] i32 skip link; == M means done
    max_leaf: int


@dataclasses.dataclass
class TraceGroup:
    """One intersectable unit: primitives sharing one transform.

    Untransformed objects merge into one group; transformed objects and
    instances keep their own (src/Helper.cpp:18-80). Instances of a base
    mesh share its ``FlatBVH`` and primitive order.
    """

    tri_vidx: Any       # [T, 3] int32 into Scene.vertices
    tri_uvoff: Any      # [T] int32
    tri_smooth: Any     # [T] bool
    tri_mat: Any        # [T] int32
    tri_tex0: Any       # [T] int32 (-1 = none)
    tri_tex1: Any       # [T] int32
    sph_cidx: Any       # [S] int32 center vertex index
    sph_radius: Any     # [S] f32
    sph_mat: Any        # [S] int32
    sph_tex0: Any       # [S] int32
    sph_tex1: Any       # [S] int32
    tri_emis: Any       # [T, 3] f32
    sph_emis: Any       # [S, 3] f32
    obj_bbox: Any       # [O, 2, 3] f32 per-source-object root boxes
    tri_obj: Any        # [T] int32 slot into obj_bbox, -1 exempt
    sph_obj: Any        # [S] int32
    minv: Any           # [4, 4] world->local
    minv_t: Any         # [4, 4] inverse-transpose (normals)
    blur: Any           # [3] motion-blur translation per unit time
    name: str
    has_xform: bool
    n_tris: int
    n_spheres: int
    has_blur: bool = False
    # flat BVH over the triangles (groups of >= bvh_min_tris), else None
    bvh: Any = None


@dataclasses.dataclass
class SphereLight:
    """Emissive sphere for next-event estimation (pages/Page7.md:7-13)."""

    center: Any
    radius: Any
    radiance: Any
    m: Any
    cof: Any
    has_xform: bool


@dataclasses.dataclass
class MeshLight:
    """Emissive mesh: world-space triangles with an area CDF."""

    a: Any
    b: Any
    c: Any
    normal: Any
    radiance: Any
    cdf: Any
    total_area: Any


@dataclasses.dataclass
class Camera:
    """Host-side camera description (src/Camera.cpp:7-139)."""

    cam_id: int
    image_name: str
    pos: np.ndarray
    gaze: np.ndarray
    up: np.ndarray
    right: np.ndarray
    near_distance: float
    left: float
    right_edge: float
    bottom: float
    top: float
    nx: int
    ny: int
    num_samples: int
    grid: int
    focus_distance: float
    aperture_size: float
    is_dof: bool
    left_handed: bool
    tonemap: tuple = None


@dataclasses.dataclass
class Scene:
    """The whole scene: tensors on one device plus static structure."""

    vertices: Any       # [V, 3] f32
    texcoords: Any      # [TC, 2] f32
    materials: Materials
    lights: Lights
    textures: Tuple[Texture, ...]
    groups: Tuple[TraceGroup, ...]
    background: Any     # [3] f32
    shadow_eps: Any     # scalar f32
    int_eps: Any        # scalar f32
    sphere_lights: Tuple = ()
    mesh_lights: Tuple = ()
    renderer: str = "whitted"
    pt_nee: bool = False
    pt_importance: bool = False
    pt_rr: bool = False
    max_depth: int = 1
    any_dielectric: bool = True
    any_brdf: bool = True
    any_conductor: bool = True
    any_rough: bool = True
    bg_texture: int = -1
    env_texture: int = -1
    n_textures: int = 0
    texture_statics: Tuple[Tuple[int, int, int, int], ...] = ()

    @property
    def device(self) -> torch.device:
        return self.vertices.device


@dataclasses.dataclass
class LoadedScene:
    """Load result: the scene plus host-side cameras."""

    scene: Scene
    cameras: list
    path: str


def to_device(obj, device, _memo=None):
    """Every numpy leaf of a scene structure as a tensor on ``device``.

    Arrays keep their dtype (float32, int32, bool); numpy scalars become
    0-d tensors; Python values (counts, flags, names) stay as they are. An
    object reached twice (the FlatBVH that instances share) is converted
    once and stays shared.
    """
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, (np.ndarray, np.generic)):
        out = torch.from_numpy(np.array(obj)).to(device)
    elif isinstance(obj, tuple):
        out = tuple(to_device(x, device, memo) for x in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, memo)
            for f in dataclasses.fields(obj)})
    else:
        return obj
    memo[id(obj)] = out     # ids are stable: the input tree holds obj
    return out
