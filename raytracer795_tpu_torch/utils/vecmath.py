"""Scalar helpers with guarded denominators and bases.

Counterpart of ``raytracer795_tpu/utils/vecmath.py``. The forward values
are the JAX package's; the guards keep masked-out lanes finite, which a
later gradient port relies on.
"""

from __future__ import annotations

import torch


def safe_pow(base: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """base ** p for base >= 0, exact at base == 0 (0^0 == 1, 0^p == 0)."""
    pos = base > 0
    safe = torch.pow(torch.where(pos, base, 1.0), p)
    return torch.where(pos, safe, torch.where(p == 0, 1.0, 0.0))


def safe_div(num: torch.Tensor, den: torch.Tensor, mask=None) -> torch.Tensor:
    """num / den with zero (or masked-out) denominators replaced by 1."""
    ok = den != 0 if mask is None else (den != 0) & mask
    return num / torch.where(ok, den, torch.ones_like(den))
