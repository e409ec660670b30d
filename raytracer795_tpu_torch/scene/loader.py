"""Scene XML loader: the reference's exact element/attribute contract.

Counterpart of ``raytracer795_tpu/scene/loader.py``: the parse pipeline of
src/Parser.h:16-1316 (defaults, 1-based index conventions, the carried-over
TextureMap parser state, the ``textureOffset - vertexOffset`` mesh quirk,
PLY loading with quad split). Parsing and BVH builds are host numpy, with
the same BVH, primitive order and prim ids as the JAX package; the
finished scene's leaves become tensors on ``device`` once, at the end.

A group of at least ``bvh_min_tris`` triangles gets one ``FlatBVH`` of any
size: the CUDA kernels walk it from device memory, so there is no
counterpart of the JAX package's VMEM packs or their 120k-triangle split.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np
import torch

from raytracer795_tpu_torch.ops import bvh as bvh_mod
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.scene.ply import read_ply

BVH_MIN_TRIS = 1024


# --------------------------------------------------------------------------
# small parse helpers
# --------------------------------------------------------------------------

def _floats(text: str) -> List[float]:
    return [float(x) for x in text.split()]


def _vec3(elem, default=None) -> np.ndarray:
    if elem is None:
        return np.asarray(default, np.float64)
    v = _floats(elem.text)
    return np.asarray(v[:3], np.float64)


def _child_float(parent, tag: str, default: float) -> float:
    e = parent.find(tag)
    return float(e.text) if e is not None else default


def _child_int(parent, tag: str, default: int) -> int:
    e = parent.find(tag)
    return int(e.text.strip()) if e is not None else default


# --------------------------------------------------------------------------
# transforms (src/Helper.cpp:135-226)
# --------------------------------------------------------------------------

def _mat_translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _mat_scale(v):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def _mat_rotate(angle_deg, axis):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = math.radians(angle_deg)
    c, s = math.cos(t), math.sin(t)
    ic = 1.0 - c
    x, y, z = a
    r = np.eye(4)
    r[:3, :3] = [
        [c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s],
        [y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s],
        [z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic],
    ]
    return r


def _parse_object_transform_refs(text: str) -> List[Tuple[str, int]]:
    """Parse the 'r1 s2 t3 c1' object transform string (src/Parser.h:769-796)."""
    refs = []
    for tok in text.split():
        refs.append((tok[0], int(tok[1:])))
    return refs


def _compose_object_matrix(refs, tables) -> np.ndarray:
    """Compose in reverse parse order, post-multiplying (src/Helper.cpp:153-176).

    glm::translate(M, v) == M @ T, applied for j = n-1 .. 0, so the final
    matrix is M = X_0 @ X_1 @ ... @ X_{n-1} with X the parse-order entries —
    i.e. the FIRST listed transform is applied LAST in world space.
    A composite reference REPLACES the accumulated matrix (src/Helper.cpp:173-175).
    """
    m = np.eye(4)
    for kind, idx in reversed(refs):
        if kind == "t":
            m = m @ _mat_translate(tables["t"][idx - 1])
        elif kind == "s":
            m = m @ _mat_scale(tables["s"][idx - 1])
        elif kind == "r":
            ang, axis = tables["r"][idx - 1]
            m = m @ _mat_rotate(ang, axis)
        elif kind == "c":
            m = tables["c"][idx - 1].copy()
    return m


# --------------------------------------------------------------------------
# texture images
# --------------------------------------------------------------------------

def _load_image(path: str) -> np.ndarray:
    """Decode PNG/JPG/EXR to [H, W, 3] float32.

    LDR images keep byte values 0..255 (the reference samples raw bytes,
    src/Texture.cpp:41-74); EXR keeps float radiance (RGBA's RGB).
    Extension sniffing matches Texture::IsPNG/IsExr (substring state machine,
    src/Texture.cpp:133-183) closely enough via lowercase suffix.
    """
    lower = path.lower()
    if ".exr" in lower:
        raise NotImplementedError(
            f"EXR images ({path}) are not ported yet: ROADMAP queue 1 "
            "items 11 and 16")
    from PIL import Image

    img = Image.open(path)
    img = img.convert("RGB")
    return np.asarray(img, np.float32)


# --------------------------------------------------------------------------
# main loader
# --------------------------------------------------------------------------

def load_scene(xml_path: str, device,
               bvh_min_tris: int = BVH_MIN_TRIS) -> T.LoadedScene:
    """Load a reference-contract XML scene onto ``device``.

    ``bvh_min_tris``: groups with at least this many triangles get a flat
    BVH (ops/bvh.py) and leaf-contiguous primitive order; smaller groups use
    the vectorized linear scan.
    """
    device = torch.device(device)
    tree = ET.parse(xml_path)
    root = tree.getroot()
    base_dir = os.path.dirname(xml_path)

    # ---- scene attributes (src/Parser.h:17-50) ----
    max_depth = _child_int(root, "MaxRecursionDepth", 1)
    renderer_e = root.find("Renderer")
    renderer = "whitted"
    if renderer_e is not None and "path" in renderer_e.text.strip().lower():
        renderer = "pathtracing"
    params_e = root.find("RendererParams")
    params = (params_e.text or "") if params_e is not None else ""
    pt_nee = "NextEventEstimation" in params
    pt_importance = "ImportanceSampling" in params
    pt_rr = "RussianRoulette" in params
    background = _vec3(root.find("BackgroundColor"), default=(0, 0, 0))
    shadow_eps = _child_float(root, "ShadowRayEpsilon", 0.002)
    int_eps = _child_float(root, "IntersectionTestEpsilon", 0.001)

    # ---- cameras (src/Parser.h:52-164, src/Camera.cpp:7-61) ----
    cameras = []
    for cam in root.find("Cameras").findall("Camera"):
        cam_id = int(cam.get("id", "0"))
        left_handed = cam.get("handedness", "") == "left"
        num_samples = _child_int(cam, "NumSamples", 1)
        focus_distance = _child_float(cam, "FocusDistance", 0.0)
        aperture = _child_float(cam, "ApertureSize", 0.0)
        is_dof = cam.find("FocusDistance") is not None
        pos = _vec3(cam.find("Position"))
        gaze_e = cam.find("Gaze")
        gaze = _vec3(gaze_e) if gaze_e is not None else np.zeros(3)
        gp = cam.find("GazePoint")
        if gp is not None:
            gaze = _vec3(gp) - pos
        up = _vec3(cam.find("Up"))
        near_dist = _child_float(cam, "NearDistance", 1.0)
        nx, ny = [int(x) for x in cam.find("ImageResolution").text.split()]
        image_name = cam.find("ImageName").text.strip()
        np_e = cam.find("NearPlane")
        if np_e is not None:
            l, r, b, t = _floats(np_e.text)
        else:
            l = r = b = t = 0.0
        fov_e = cam.find("FovY")
        if fov_e is not None:
            half = math.radians(float(fov_e.text) * 0.5)
            y = math.tan(half) * near_dist
            x = (nx / ny) * y
            l, r, b, t = -x, x, -y, y

        # basis (src/Camera.cpp:33-42): w = -gaze (right-handed) or +gaze
        gaze_n = gaze / np.linalg.norm(gaze)
        w = gaze_n if left_handed else -gaze_n
        right = np.cross(up, w)
        right = right / np.linalg.norm(right)
        up_o = np.cross(w, right)

        # jitter grid: smallest g with g*g >= num_samples (src/Camera.cpp:21-28)
        g = 1
        while g * g < num_samples:
            g += 1

        # optional global tonemapping (the reference's attempted hw5
        # feature, pages/Page5.md §5.1.f; course element contract)
        tonemap = None
        tm_e = cam.find("Tonemap")
        if tm_e is not None:
            opts = _floats(tm_e.find("TMOOptions").text) \
                if tm_e.find("TMOOptions") is not None else [0.18, 1.0]
            tonemap = (float(opts[0]), float(opts[1]) if len(opts) > 1
                       else 1.0,
                       _child_float(tm_e, "Saturation", 1.0),
                       _child_float(tm_e, "Gamma", 2.2))

        cameras.append(T.Camera(
            cam_id=cam_id, image_name=image_name, pos=pos, gaze=gaze_n,
            up=up_o, right=right, near_distance=near_dist,
            left=l, right_edge=r, bottom=b, top=t, nx=nx, ny=ny,
            num_samples=num_samples, grid=g, focus_distance=focus_distance,
            aperture_size=aperture, is_dof=is_dof, left_handed=left_handed,
            tonemap=tonemap,
        ))

    # ---- BRDFs (src/Parser.h:166-302) ----
    brdf_by_id: Dict[int, Tuple[int, int]] = {}  # id -> (brdf_type, exponent)
    brdfs_e = root.find("BRDFs")
    if brdfs_e is not None:
        kinds = [
            ("ModifiedBlinnPhong", "normalized", T.BRDF_MBP, T.BRDF_MBPN),
            ("OriginalBlinnPhong", None, T.BRDF_OBP, T.BRDF_OBP),
            ("ModifiedPhong", "normalized", T.BRDF_MP, T.BRDF_MPN),
            ("OriginalPhong", None, T.BRDF_OP, T.BRDF_OP),
            ("TorranceSparrow", "kdfresnel", T.BRDF_TS, T.BRDF_TSF),
        ]
        for tag, flag_attr, plain, flagged in kinds:
            for e in brdfs_e.findall(tag):
                bid = int(e.get("id"))
                exp = _child_int(e, "Exponent", 1)
                flag = flag_attr is not None and e.get(flag_attr, "") == "true"
                brdf_by_id[bid] = (flagged if flag else plain, exp)

    # ---- materials (src/Parser.h:304-474) ----
    mats: List[dict] = []
    for m in root.find("Materials").findall("Material"):
        d = {}
        d["ambient"] = _vec3(m.find("AmbientReflectance"), (0, 0, 0))
        d["diffuse"] = _vec3(m.find("DiffuseReflectance"), (0, 0, 0))
        d["specular"] = _vec3(m.find("SpecularReflectance"), (0, 0, 0))
        if m.get("degamma", "") == "true":
            for k in ("ambient", "diffuse", "specular"):
                d[k] = d[k] ** 2.2
        d["mirror"] = _vec3(m.find("MirrorReflectance"), (0, 0, 0))
        d["phong"] = float(_child_int(m, "PhongExponent", 0))
        d["refraction"] = _child_float(m, "RefractionIndex", 0.0)
        d["absorption_index"] = _child_float(m, "AbsorptionIndex", 0.0)
        d["absorption_coef"] = _vec3(m.find("AbsorptionCoefficient"), (0, 0, 0))
        rough_e = m.find("Roughness")
        d["roughness"] = float(rough_e.text) if rough_e is not None else 0.0
        d["is_rough"] = rough_e is not None
        mtype = {"mirror": T.MAT_MIRROR, "conductor": T.MAT_CONDUCTOR,
                 "dielectric": T.MAT_DIELECTRIC}.get(m.get("type", ""), T.MAT_NORMAL)
        d["mtype"] = mtype
        d["brdf"] = T.BRDF_NONE
        brdf_ref = m.get("BRDF")
        if brdf_ref is not None and int(brdf_ref) in brdf_by_id:
            bt, exp = brdf_by_id[int(brdf_ref)]
            d["brdf"] = bt
            d["phong"] = float(exp)  # BRDF exponent overrides (src/Parser.h:342)
        mats.append(d)

    materials = T.Materials(
        ambient=np.array([d["ambient"] for d in mats], np.float32),
        diffuse=np.array([d["diffuse"] for d in mats], np.float32),
        specular=np.array([d["specular"] for d in mats], np.float32),
        mirror=np.array([d["mirror"] for d in mats], np.float32),
        phong=np.array([d["phong"] for d in mats], np.float32),
        refraction=np.array([d["refraction"] for d in mats], np.float32),
        absorption_index=np.array([d["absorption_index"] for d in mats], np.float32),
        absorption_coef=np.array([d["absorption_coef"] for d in mats], np.float32),
        roughness=np.array([d["roughness"] for d in mats], np.float32),
        is_rough=np.array([d["is_rough"] for d in mats], bool),
        mtype=np.array([d["mtype"] for d in mats], np.int32),
        brdf=np.array([d["brdf"] for d in mats], np.int32),
    )

    # ---- textures (src/Parser.h:476-605) ----
    image_paths: List[str] = []
    textures: List[T.Texture] = []
    tex_e = root.find("Textures")
    if tex_e is not None:
        imgs_e = tex_e.find("Images")
        if imgs_e is not None:
            for im in imgs_e.findall("Image"):
                image_paths.append(os.path.join(base_dir, im.text.strip()))
        # Parser state deliberately carries over between TextureMap elements
        # (the reference declares these outside the loop, src/Parser.h:480-486).
        st = dict(normalizer=255, noise_scale=1.0, bump_factor=1.0,
                  dm=T.DECAL_NONE, nc=T.NC_LINEAR, interp=T.INTERP_NN,
                  image_id=0)
        dm_map = {"blend_kd": T.DECAL_BLEND_KD, "replace_kd": T.DECAL_REPLACE_KD,
                  "replace_all": T.DECAL_REPLACE_ALL, "bump_normal": T.DECAL_BUMP_NORMAL,
                  "replace_normal": T.DECAL_REPLACE_NORMAL,
                  "replace_background": T.DECAL_REPLACE_BACKGROUND}
        for tm in tex_e.findall("TextureMap"):
            is_image = tm.get("type", "") == "image"
            st["image_id"] = _child_int(tm, "ImageId", st["image_id"])
            dm_e = tm.find("DecalMode")
            if dm_e is not None:
                st["dm"] = dm_map.get(dm_e.text.strip(), st["dm"])
            nc_e = tm.find("NoiseConversion")
            if nc_e is not None:
                st["nc"] = T.NC_ABSVAL if nc_e.text.strip() == "absval" else T.NC_LINEAR
            ip_e = tm.find("Interpolation")
            if ip_e is not None:
                txt = ip_e.text.strip()
                if txt == "nearest":
                    st["interp"] = T.INTERP_NN
                elif txt == "bilinear":
                    st["interp"] = T.INTERP_BILINEAR
            st["normalizer"] = _child_int(tm, "Normalizer", st["normalizer"])
            st["noise_scale"] = _child_float(tm, "NoiseScale", st["noise_scale"])
            st["bump_factor"] = _child_float(tm, "BumpFactor", st["bump_factor"])

            if is_image:
                image = _load_image(image_paths[st["image_id"] - 1])
                ttype = T.TEX_IMAGE
            else:
                image = np.zeros((1, 1, 3), np.float32)
                ttype = T.TEX_PERLIN
            textures.append(T.Texture(
                image=image.astype(np.float32),
                normalizer=np.float32(st["normalizer"]),
                bump_factor=np.float32(st["bump_factor"]),
                noise_scale=np.float32(st["noise_scale"]),
                decal=st["dm"], interp=st["interp"], ttype=ttype, nc=st["nc"],
            ))

    # ---- transformations (src/Parser.h:607-681) ----
    tables = {"t": [], "s": [], "r": [], "c": []}
    tr_e = root.find("Transformations")
    if tr_e is not None:
        for e in tr_e.findall("Translation"):
            tables["t"].append(_floats(e.text))
        for e in tr_e.findall("Scaling"):
            tables["s"].append(_floats(e.text))
        for e in tr_e.findall("Rotation"):
            v = _floats(e.text)
            tables["r"].append((v[0], v[1:4]))
        for e in tr_e.findall("Composite"):
            v = _floats(e.text)
            # row-major 16 floats (sscanf order fills [col][row] transposed:
            # src/Parser.h:669-677 reads composite[c][r] row by row, i.e. the
            # XML text is row-major of the matrix).
            tables["c"].append(np.array(v, np.float64).reshape(4, 4))

    # ---- vertices / texcoords (src/Parser.h:684-767) ----
    vd = root.find("VertexData")
    vertices = (np.array(_floats(vd.text), np.float64).reshape(-1, 3)
                if vd is not None and vd.text and vd.text.split() else np.zeros((0, 3)))
    tc = root.find("TexCoordData")
    texcoords = (np.array(_floats(tc.text), np.float64).reshape(-1, 2)
                 if tc is not None and tc.text and tc.text.split() else np.zeros((0, 2)))
    vertices = [row for row in vertices]     # grows with PLY loads
    texcoords = [row for row in texcoords]

    # ---- objects (src/Parser.h:798-1195) ----
    objs_e = root.find("Objects")

    def parse_textures_elem(o) -> List[int]:
        e = o.find("Textures")
        if e is None:
            return []
        return [int(x) for x in e.text.split()][:2]

    def parse_blur(o):
        e = o.find("MotionBlur")
        return (_floats(e.text) if e is not None else [0.0, 0.0, 0.0],
                e is not None)

    def parse_xform(o):
        e = o.find("Transformations")
        if e is None:
            return []
        return _parse_object_transform_refs(e.text)

    # intermediate object records before grouping
    obj_records = []       # dicts
    mesh_by_id: Dict[int, dict] = {}

    def parse_radiance(o):
        e = o.find("Radiance")
        return np.asarray(_floats(e.text) if e is not None else [0.0, 0.0, 0.0])

    for tag in ("Sphere", "LightSphere"):
        for o in objs_e.findall(tag):
            blur, is_blur = parse_blur(o)
            rec = dict(
                kind="sphere", oid=int(o.get("id", "0")),
                mat=_child_int(o, "Material", 1) - 1,
                tex=parse_textures_elem(o),
                xform=parse_xform(o), blur=np.asarray(blur),
                has_blur=is_blur,
                cidx=_child_int(o, "Center", 1) - 1,
                radius=_child_float(o, "Radius", 1.0),
                radiance=parse_radiance(o),
                is_light=tag == "LightSphere",
            )
            obj_records.append(rec)

    for o in objs_e.findall("Triangle"):
        blur, is_blur = parse_blur(o)
        p = [int(x) for x in o.find("Indices").text.split()]
        rec = dict(
            kind="mesh", oid=int(o.get("id", "0")),
            mat=_child_int(o, "Material", 1) - 1,
            tex=parse_textures_elem(o),
            xform=parse_xform(o), blur=np.asarray(blur), has_blur=is_blur,
            faces=np.asarray([[p[0] - 1, p[1] - 1, p[2] - 1]], np.int64),
            uvoff=0, smooth=False,
            radiance=np.zeros(3), is_light=False,
        )
        obj_records.append(rec)

    mesh_like = ([(o, False) for o in objs_e.findall("Mesh")]
                 + [(o, True) for o in objs_e.findall("LightMesh")])
    for o, is_light in mesh_like:
        blur, is_blur = parse_blur(o)
        smooth = o.get("shadingMode", "") == "smooth"
        faces_e = o.find("Faces")
        ply_file = faces_e.get("plyFile")
        if ply_file is not None:
            ply = read_ply(os.path.join(base_dir, ply_file))
            # uv coords appended before vertices; textureOffset/vertexOffset
            # bookkeeping per src/Parser.h:1049-1102
            txt_off = len(texcoords) + 1
            if ply.uv is not None:
                for row in ply.uv:
                    texcoords.append(np.asarray(row))
            vcount = len(vertices) + 1       # 1-based offset of new vertices
            faces = []
            for f in ply.faces:
                if len(f) == 4:
                    faces.append([f[0], f[1], f[2]])
                    faces.append([f[2], f[3], f[0]])
                else:
                    faces.append([f[0], f[1], f[2]])
            faces = np.asarray(faces, np.int64) + (vcount - 1)  # 0-based rows
            for row in ply.vertices:
                vertices.append(np.asarray(row))
            uvoff = (txt_off - vcount)
        else:
            voff = int(faces_e.get("vertexOffset", "0"))
            toff = int(faces_e.get("textureOffset", "0"))
            idx = [int(x) for x in faces_e.text.split()]
            faces = (np.asarray(idx, np.int64).reshape(-1, 3) + voff) - 1
            uvoff = toff - voff
        rec = dict(
            kind="mesh", oid=int(o.get("id", "0")),
            mat=_child_int(o, "Material", 1) - 1,
            tex=parse_textures_elem(o),
            xform=parse_xform(o), blur=np.asarray(blur), has_blur=is_blur,
            faces=faces, uvoff=uvoff, smooth=smooth,
            radiance=parse_radiance(o), is_light=is_light,
        )
        obj_records.append(rec)
        mesh_by_id[rec["oid"]] = rec

    instance_records = []
    for o in objs_e.findall("MeshInstance"):
        blur, is_blur = parse_blur(o)
        instance_records.append(dict(
            oid=int(o.get("id", "0")),
            base=int(o.get("baseMeshId", "0")),
            reset=o.get("resetTransform", "false") == "true",
            mat=_child_int(o, "Material", 1) - 1,
            xform=parse_xform(o), blur=np.asarray(blur), has_blur=is_blur,
        ))

    vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
    if len(texcoords):
        texcoords = np.asarray(texcoords, np.float64).reshape(-1, 2)
    else:
        texcoords = np.zeros((1, 2), np.float64)

    # ---- object matrices (src/Helper.cpp:135-226) ----
    for rec in obj_records:
        rec["matrix"] = _compose_object_matrix(rec["xform"], tables)
    for rec in instance_records:
        m = _compose_object_matrix(rec["xform"], tables)
        base = mesh_by_id[rec["base"]]
        if not rec["reset"]:
            m = m @ base["matrix"]          # src/Helper.cpp:216-218
        rec["matrix"] = m
        rec["base_rec"] = base

    # ---- grouping: merge untransformed/unblurred objects ----
    def is_identity(rec):
        return (not rec["xform"]) and (not rec["has_blur"])

    groups: List[T.TraceGroup] = []

    def tex_ids(rec):
        t = rec.get("tex", [])
        t0 = t[0] - 1 if len(t) > 0 else -1
        t1 = t[1] - 1 if len(t) > 1 else -1
        return t0, t1

    def empty_tri_arrays():
        return dict(tri_vidx=np.zeros((0, 3), np.int32),
                    tri_uvoff=np.zeros((0,), np.int32),
                    tri_smooth=np.zeros((0,), bool),
                    tri_mat=np.zeros((0,), np.int32),
                    tri_tex0=np.zeros((0,), np.int32),
                    tri_tex1=np.zeros((0,), np.int32),
                    tri_obj=np.zeros((0,), np.int32),
                    tri_emis=np.zeros((0, 3), np.float32))

    def empty_sph_arrays():
        # sphere objects are single-primitive, so their reference BVH is a
        # lone leaf with no bbox test (src/BVH.cpp:67-74): always exempt.
        return dict(sph_cidx=np.zeros((0,), np.int32),
                    sph_radius=np.zeros((0,), np.float32),
                    sph_mat=np.zeros((0,), np.int32),
                    sph_tex0=np.zeros((0,), np.int32),
                    sph_tex1=np.zeros((0,), np.int32),
                    sph_obj=np.full((0,), -1, np.int32),
                    sph_emis=np.zeros((0, 3), np.float32))

    def rec_tri_arrays(rec, mat_idx, obj_slot):
        t0, t1 = tex_ids(rec)
        n = len(rec["faces"])
        return dict(
            tri_vidx=rec["faces"].astype(np.int32),
            tri_uvoff=np.full((n,), rec["uvoff"], np.int32),
            tri_smooth=np.full((n,), rec["smooth"], bool),
            tri_mat=np.full((n,), mat_idx, np.int32),
            tri_tex0=np.full((n,), t0, np.int32),
            tri_tex1=np.full((n,), t1, np.int32),
            tri_obj=np.full((n,), obj_slot if n >= 2 else -1, np.int32),
            tri_emis=np.broadcast_to(
                rec.get("radiance", np.zeros(3)).astype(np.float32),
                (n, 3)).copy(),
        )

    def rec_bbox(rec):
        """Root BVH bbox over the mesh's triangles (src/BVH.cpp:268-283)."""
        pts = vertices[rec["faces"].reshape(-1)]
        return np.stack([pts.min(0), pts.max(0)]).astype(np.float32)

    def rec_sph_arrays(rec, mat_idx):
        t0, t1 = tex_ids(rec)
        return dict(
            sph_cidx=np.asarray([rec["cidx"]], np.int32),
            sph_radius=np.asarray([rec["radius"]], np.float32),
            sph_mat=np.asarray([mat_idx], np.int32),
            sph_tex0=np.asarray([t0], np.int32),
            sph_tex1=np.asarray([t1], np.int32),
            sph_obj=np.full((1,), -1, np.int32),
            sph_emis=rec.get("radiance", np.zeros(3)).astype(np.float32)[None],
        )

    # flat-BVH build, shared across instances of the same base mesh: the
    # BVH lives in group-local space (rays are transformed by minv first),
    # exactly like the reference's shared baseMesh->bvh (src/Helper.cpp:54).
    _bvh_cache: Dict = {}

    def maybe_bvh(tri, cache_key=None):
        n = len(tri["tri_vidx"])
        if n < max(bvh_min_tris, 2):
            return tri, None
        cached = _bvh_cache.get(cache_key) if cache_key is not None else None
        if cached is None:
            pbmin, pbmax = bvh_mod.tri_bounds(vertices, tri["tri_vidx"])
            cached = bvh_mod.build(pbmin, pbmax)
            if cache_key is not None:
                _bvh_cache[cache_key] = cached
        flat, perm = cached
        tri = {k: v[perm] for k, v in tri.items()}
        return tri, flat

    def make_group(name, tri, sph, matrix, blur, has_xform, obj_bbox=None,
                   bvh_key=None):
        tri, flat_bvh = maybe_bvh(tri, bvh_key)
        minv = np.linalg.inv(matrix) if has_xform else np.eye(4)
        minv_t = np.linalg.inv(matrix).T if has_xform else np.eye(4)
        if obj_bbox is None or len(obj_bbox) == 0:
            obj_bbox = np.zeros((0, 2, 3), np.float32)
        else:
            obj_bbox = np.asarray(obj_bbox, np.float32).reshape(-1, 2, 3)
        return T.TraceGroup(
            **{k: v for k, v in tri.items()},
            **{k: v for k, v in sph.items()},
            obj_bbox=obj_bbox,
            minv=minv.astype(np.float32), minv_t=minv_t.astype(np.float32),
            blur=np.asarray(blur, np.float32),
            name=name, has_xform=has_xform,
            has_blur=bool(np.any(np.asarray(blur, np.float32) != 0.0)),
            n_tris=len(tri["tri_vidx"]), n_spheres=len(sph["sph_cidx"]),
            bvh=flat_bvh,
        )

    # merged static group
    static_tri = empty_tri_arrays()
    static_sph = empty_sph_arrays()
    static_bboxes = []
    for rec in obj_records:
        if not is_identity(rec):
            continue
        if rec["kind"] == "sphere":
            arr = rec_sph_arrays(rec, rec["mat"])
            static_sph = {k: np.concatenate([static_sph[k], arr[k]]) for k in static_sph}
        else:
            slot = len(static_bboxes) if len(rec["faces"]) >= 2 else -1
            arr = rec_tri_arrays(rec, rec["mat"], slot)
            if slot >= 0:
                static_bboxes.append(rec_bbox(rec))
            static_tri = {k: np.concatenate([static_tri[k], arr[k]]) for k in static_tri}
    if len(static_tri["tri_vidx"]) or len(static_sph["sph_cidx"]):
        groups.append(make_group("static", static_tri, static_sph,
                                 np.eye(4), np.zeros(3), has_xform=False,
                                 obj_bbox=static_bboxes))

    # transformed/blurred objects: own groups
    for rec in obj_records:
        if is_identity(rec):
            continue
        if rec["kind"] == "sphere":
            groups.append(make_group(
                f"sphere#{rec['oid']}", empty_tri_arrays(),
                rec_sph_arrays(rec, rec["mat"]), rec["matrix"], rec["blur"],
                has_xform=bool(rec["xform"])))
        else:
            multi = len(rec["faces"]) >= 2
            groups.append(make_group(
                f"mesh#{rec['oid']}", rec_tri_arrays(rec, rec["mat"],
                                                     0 if multi else -1),
                empty_sph_arrays(), rec["matrix"], rec["blur"],
                has_xform=bool(rec["xform"]),
                obj_bbox=[rec_bbox(rec)] if multi else None,
                bvh_key=("mesh", rec["oid"])))

    # instances: share the base mesh's geometry (tri_vidx aliases the same
    # array) with the instance's material baked into tri_mat — the runtime
    # equivalent of src/Helper.cpp:53-73's matIndex override.
    for rec in instance_records:
        base = rec["base_rec"]
        multi = len(base["faces"]) >= 2
        groups.append(make_group(
            f"instance#{rec['oid']}", rec_tri_arrays(base, rec["mat"],
                                                     0 if multi else -1),
            empty_sph_arrays(), rec["matrix"], rec["blur"], has_xform=True,
            obj_bbox=[rec_bbox(base)] if multi else None,
            bvh_key=("mesh", rec["base"])))

    # ---- object-light sampling tables (pages/Page7.md:7-13) ----
    sphere_lights = []
    mesh_lights = []
    for rec in obj_records:
        if not rec.get("is_light"):
            continue
        m = rec["matrix"]
        if rec["kind"] == "sphere":
            m3 = m[:3, :3]
            cof = np.linalg.det(m3) * np.linalg.inv(m3).T
            sphere_lights.append(T.SphereLight(
                center=vertices[rec["cidx"]].astype(np.float32),
                radius=np.float32(rec["radius"]),
                radiance=rec["radiance"].astype(np.float32),
                m=m.astype(np.float32), cof=cof.astype(np.float32),
                has_xform=bool(rec["xform"]),
            ))
        else:
            tri = rec["faces"]
            a = vertices[tri[:, 0]]
            b = vertices[tri[:, 1]]
            c = vertices[tri[:, 2]]
            # bake the world transform (static) into the sampling table
            def xf(p):
                return p @ m[:3, :3].T + m[:3, 3]
            a, b, c = xf(a), xf(b), xf(c)
            n = np.cross(c - b, a - b)
            areas = 0.5 * np.linalg.norm(n, axis=-1)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            total = float(areas.sum())
            cdf = np.cumsum(areas) / max(total, 1e-20)
            mesh_lights.append(T.MeshLight(
                a=a.astype(np.float32), b=b.astype(np.float32),
                c=c.astype(np.float32), normal=n.astype(np.float32),
                radiance=rec["radiance"].astype(np.float32),
                cdf=cdf.astype(np.float32), total_area=np.float32(total),
            ))

    # ---- lights (src/Parser.h:1197-1315) ----
    lights_e = root.find("Lights")
    amb = np.zeros(3)
    p_pos, p_int = [], []
    d_dir, d_rad = [], []
    s_pos, s_dir, s_int, s_cov, s_fall = [], [], [], [], []
    a_pos, a_norm, a_rad, a_size = [], [], [], []
    env_texture = -1
    if lights_e is not None:
        amb_e = lights_e.find("AmbientLight")
        if amb_e is not None:
            amb = np.asarray(_floats(amb_e.text))
        for e in lights_e.findall("PointLight"):
            p_pos.append(_vec3(e.find("Position")))
            p_int.append(_vec3(e.find("Intensity")))
        for e in lights_e.findall("DirectionalLight"):
            d_dir.append(_vec3(e.find("Direction")))
            d_rad.append(_vec3(e.find("Radiance")))
        for e in lights_e.findall("SpotLight"):
            s_pos.append(_vec3(e.find("Position")))
            s_dir.append(_vec3(e.find("Direction")))
            s_int.append(_vec3(e.find("Intensity")))
            # half-angles in radians (src/Light.cpp:332-333)
            s_cov.append(math.radians(_child_float(e, "CoverageAngle", 0.0) * 0.5))
            s_fall.append(math.radians(_child_float(e, "FalloffAngle", 0.0) * 0.5))
        for e in lights_e.findall("AreaLight"):
            a_pos.append(_vec3(e.find("Position")))
            a_norm.append(_vec3(e.find("Normal")))
            rad_e = e.find("Radiance")
            if rad_e is None:
                rad_e = e.find("Intensity")   # fallback (src/Parser.h:1288-1291)
            a_rad.append(_vec3(rad_e))
            a_size.append(_child_float(e, "Size", 1.0))
        if lights_e.find("SphericalDirectionalLight") is not None:
            raise NotImplementedError(
                "environment lights sample with the RNG that matches JAX "
                "and read EXR images: ROADMAP queue 1 items 10-11")

    def v3list(lst):
        return (np.asarray(lst, np.float32).reshape(-1, 3)
                if lst else np.zeros((0, 3), np.float32))

    def f1list(lst):
        return np.asarray(lst, np.float32) if lst else np.zeros((0,), np.float32)

    def _normalized_rows(a):
        if len(a) == 0:
            return a
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    a_norm_arr = _normalized_rows(v3list(a_norm))
    # area-light orthonormal frame (src/Light.cpp:450-451)
    a_u, a_v = [], []
    for n in a_norm_arr:
        nn = n.copy()
        idx = int(np.argmin(np.abs(nn)))
        nl = nn.copy()
        nl[idx] = 1.0
        u = np.cross(nn, nl)
        u = u / np.linalg.norm(u)
        a_u.append(u)
        a_v.append(np.cross(nn, u))
    lights = T.Lights(
        ambient=amb.astype(np.float32),
        point_pos=v3list(p_pos), point_intensity=v3list(p_int),
        dir_dir=_normalized_rows(v3list(d_dir)), dir_radiance=v3list(d_rad),
        spot_pos=v3list(s_pos), spot_dir=_normalized_rows(v3list(s_dir)),
        spot_intensity=v3list(s_int),
        spot_coverage=f1list(s_cov), spot_falloff=f1list(s_fall),
        area_pos=v3list(a_pos), area_normal=a_norm_arr,
        area_u=v3list(a_u), area_v=v3list(a_v),
        area_radiance=v3list(a_rad), area_size=f1list(a_size),
    )

    # background texture = last ReplaceBackground texture (src/Scene.cpp:494-500)
    bg_texture = -1
    for i, t in enumerate(textures):
        if t.decal == T.DECAL_REPLACE_BACKGROUND:
            bg_texture = i

    scene = T.Scene(
        vertices=vertices.astype(np.float32),
        texcoords=texcoords.astype(np.float32),
        materials=materials,
        lights=lights,
        textures=tuple(textures),
        groups=tuple(groups),
        background=background.astype(np.float32),
        shadow_eps=np.float32(shadow_eps),
        int_eps=np.float32(int_eps),
        sphere_lights=tuple(sphere_lights),
        mesh_lights=tuple(mesh_lights),
        renderer=renderer, pt_nee=pt_nee, pt_importance=pt_importance,
        pt_rr=pt_rr,
        max_depth=max_depth,
        any_dielectric=bool(np.any(np.asarray(materials.mtype)
                                   == T.MAT_DIELECTRIC)),
        any_brdf=bool(np.any(np.asarray(materials.brdf) != T.BRDF_NONE)),
        any_conductor=bool(np.any(np.asarray(materials.mtype)
                                  == T.MAT_CONDUCTOR)),
        any_rough=bool(np.any(np.asarray(materials.is_rough))),
        bg_texture=bg_texture,
        env_texture=env_texture,
        n_textures=len(textures),
        texture_statics=tuple((t.decal, t.interp, t.ttype, t.nc) for t in textures),
    )
    # every leaf moves to the device once; instances keep sharing their
    # base mesh's FlatBVH tensors
    return T.LoadedScene(scene=T.to_device(scene, device), cameras=cameras,
                         path=xml_path)
