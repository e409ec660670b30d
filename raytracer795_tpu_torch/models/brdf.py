"""The 8 analytic BRDF models, evaluated per lane and selected by type.

Counterpart of ``raytracer795_tpu/models/brdf.py``. Dispatch contract:
Light::TermBRDF (src/Light.cpp:62-155); radiance L * f * max(0, n.wi):
Light::BRDF (src/Light.cpp:157-162).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils.vec3 import (Vec3, cdiv, vdot,
                                               vsafe_normalize, vwhere)
from raytracer795_tpu_torch.utils.vecmath import safe_div, safe_pow

_EPS = 1e-3  # Light::_epsilon (src/Light.h:16)


def _conductor_fresnel(n_t, k_t, d: Vec3, normal: Vec3):
    """Fresnel for conductors (src/Light.cpp:18-28); d = incoming direction."""
    cos_t = -vdot(d, normal)
    two = 2.0 * n_t * cos_t
    cos2 = cos_t * cos_t
    nk2 = n_t * n_t + k_t * k_t
    rs = safe_div(nk2 - two + cos2, nk2 + two + cos2)
    rp = safe_div(nk2 * cos2 - two + 1.0, nk2 * cos2 + two + 1.0)
    return 0.5 * (rs + rp)


def _mat3_rows(tbl, idx) -> Vec3:
    """Gather [M, 3] material-table rows into lane components."""
    rec = tbl[idx.long()]
    return Vec3(rec[:, 0], rec[:, 1], rec[:, 2])


class BrdfRec(NamedTuple):
    """Per-lane material rows for BRDF evaluation, gathered once per pass."""

    kd: Vec3
    ks: Vec3
    p: Any          # [N] phong exponent
    btype: Any      # [N] int32 BRDF_*
    refr: Any       # [N] refraction index (TSF Fresnel)
    absidx: Any     # [N] absorption index


def gather_brdf_rec(mats, mat_idx) -> BrdfRec:
    mi = mat_idx.long()
    return BrdfRec(kd=_mat3_rows(mats.diffuse, mi),
                   ks=_mat3_rows(mats.specular, mi),
                   p=mats.phong[mi], btype=mats.brdf[mi],
                   refr=mats.refraction[mi],
                   absidx=mats.absorption_index[mi])


def term_brdf_rec(wi: Vec3, wo: Vec3, normal: Vec3, rec: BrdfRec) -> Vec3:
    """f(wi, wo) per lane (Vec3) given pre-gathered material rows."""
    kd, ks, p, btype = rec.kd, rec.ks, rec.p, rec.btype
    pi = math.pi

    n_wi = vdot(normal, wi)
    wr = vsafe_normalize(-wi + normal * (2.0 * n_wi))
    cos_r = torch.clamp_min(vdot(wr, wo), 0.0)          # Phong lobes
    h = vsafe_normalize(wo + wi)
    cos_h = torch.clamp_min(vdot(normal, h), 0.0)       # Blinn lobes
    cos_i = torch.clamp_min(vdot(wi, normal), 0.0)

    pow_r = safe_pow(cos_r, p)
    pow_h = safe_pow(cos_h, p)

    # Phong family (src/Light.cpp:63-93)
    f_mp = kd + ks * pow_r
    guard = cos_i >= _EPS
    inv_ci = 1.0 / torch.clamp_min(cos_i, _EPS)
    f_op = vwhere(guard, kd + ks * (pow_r * inv_ci), 0.0)
    f_mpn = cdiv(kd, pi) + ks * (cdiv(p + 2.0, 2.0 * pi) * pow_r)

    # Blinn-Phong family (src/Light.cpp:94-121)
    f_mbp = kd + ks * pow_h
    f_obp = vwhere(guard, kd + ks * (pow_h * inv_ci), 0.0)
    f_mbpn = cdiv(kd, pi) + ks * (cdiv(p + 8.0, 8.0 * pi) * pow_h)

    # Torrance-Sparrow (src/Light.cpp:122-154)
    cos_alpha = torch.clamp_min(vdot(h, normal), 0.0)
    cos_theta = vdot(wi, normal)
    cos_phi = vdot(wo, normal)
    d_ts = cdiv(p + 2.0, 2.0 * pi) * safe_pow(cos_alpha, p)
    g_left = safe_div(2.0 * vdot(normal, h) * vdot(normal, wo), vdot(wo, h))
    g_right = safe_div(2.0 * vdot(normal, h) * vdot(normal, wi), vdot(wi, h))
    g_ts = torch.clamp_max(torch.minimum(g_left, g_right), 1.0)
    spec_ts = ks * safe_div(g_ts * d_ts, 4.0 * cos_phi * cos_theta)
    f_ts = cdiv(kd, pi) + spec_ts
    fr = _conductor_fresnel(rec.refr, rec.absidx, -wo, normal)
    f_tsf = cdiv(kd, pi) * (1.0 - fr) + spec_ts * fr

    out = f_mbp  # every lane with a BRDF gets overwritten
    for code, f in ((T.BRDF_MP, f_mp), (T.BRDF_OP, f_op), (T.BRDF_MPN, f_mpn),
                    (T.BRDF_MBP, f_mbp), (T.BRDF_OBP, f_obp),
                    (T.BRDF_MBPN, f_mbpn), (T.BRDF_TS, f_ts),
                    (T.BRDF_TSF, f_tsf)):
        out = vwhere(btype == code, f, out)
    return out
