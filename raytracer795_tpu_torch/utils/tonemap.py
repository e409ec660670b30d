"""Global tonemapping operator (the reference's hw5 global TMO).

Counterpart of ``raytracer795_tpu/utils/tonemap.py``, host numpy as there:
the film is on the host when it is tonemapped, and ``np.percentile`` of the
same float32 array gives the JAX package's result bit for bit. The
photographic operator (Reinhard et al. 2002):

    L_w   = exp(mean(log(eps + L)))                 (log-average luminance)
    L_m   = (key / L_w) * L                         (key value, default .18)
    L_white = the ``burn`` percentile of L_m        (burnout knob)
    L_d   = L_m (1 + L_m / L_white^2) / (1 + L_m)
    C_out = clip(L_d * (C / L)^saturation, 0, 1) ^ (1/gamma) * 255

Zero-luminance pixels stay out of the log average (the reference averaged
them in, pages/Page5.md:101) and pass through as black.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-6
_LUM = np.array([0.2126, 0.7152, 0.0722], np.float32)     # Rec.709


def reinhard_global(img: np.ndarray, key: float = 0.18,
                    burn_percent: float = 1.0, saturation: float = 1.0,
                    gamma: float = 2.2) -> np.ndarray:
    """HDR [H, W, 3] radiance -> LDR floats in [0, 255].

    ``burn_percent``: the share of lit pixels, in percent, allowed to burn
    to white (the L_white percentile); 0 gives the plain Reinhard curve.
    """
    img = np.asarray(img, np.float32)
    lum = img @ _LUM
    lit = lum > 0.0
    if not lit.any():
        return np.zeros_like(img)
    log_avg = float(np.exp(np.mean(np.log(_EPS + lum[lit]))))
    lm = (key / max(log_avg, _EPS)) * lum
    if burn_percent > 0:
        l_white = max(float(np.percentile(lm[lit], 100.0 - burn_percent)),
                      _EPS)
        ld = lm * (1.0 + lm / (l_white * l_white)) / (1.0 + lm)
    else:
        ld = lm / (1.0 + lm)
    safe_lum = np.where(lit, lum, 1.0)
    ratio = np.clip(img / safe_lum[..., None], 0.0, None) ** saturation
    out = np.clip(ld[..., None] * ratio, 0.0, 1.0) ** (1.0 / gamma)
    return (out * 255.0).astype(np.float32)
