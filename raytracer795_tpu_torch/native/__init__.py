"""Host-side native code, compiled on first use.

The flat-BVH builder is the port's own copy of the JAX package's C++
source, ``csrc/bvh_builder.cpp``: the port reads no file of that package.
``g++ -O3 -shared`` builds it into ``build/native/`` at the repository
root, keyed by a hash of the source, and ``ctypes`` loads it.
Where no compiler is available ``load_bvh_builder`` returns None and
ops/bvh.py uses its numpy builder, which gives the same hits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BVH_BUILDER_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")

_LOCK = threading.Lock()
_LIBS: dict = {}


def load_bvh_builder() -> "ctypes.CDLL | None":
    """Compile (if needed) and dlopen the BVH builder; None on failure."""
    with _LOCK:
        if "bvh_builder" in _LIBS:
            return _LIBS["bvh_builder"]
        try:
            with open(BVH_BUILDER_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            os.makedirs(BUILD_DIR, exist_ok=True)
            so = os.path.join(BUILD_DIR, f"bvh_builder-{digest}.so")
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(["g++", "-O3", "-std=c++17", "-shared",
                                "-fPIC", "-o", tmp, BVH_BUILDER_SRC],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _LIBS["bvh_builder"] = lib
        return lib
