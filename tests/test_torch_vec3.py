"""utils/vec3.py and utils/vecmath.py: the port against the JAX package.

The same seeded float32 inputs, with zeros, ties and a NaN lane among
them, go through each helper of both packages. The helpers keep the JAX
package's operation order, so products, sums and quotients must be equal
bit for bit (NaN where the JAX package gives NaN). Helpers that take a
square root or a power agree within 1e-6: XLA's CPU code computes
``1 / sqrt`` and ``pow`` with other instruction sequences than PyTorch's,
a few ulp apart.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

N = 512
# helpers through sqrt or pow: (rtol, atol); the rest must be exact
ULP_TOL = {name: (1e-6, 1e-6) for name in (
    "vnormalize", "vmasked_normalize", "vreflect", "vorthonormal_u",
    "safe_pow")}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, 3)).astype(np.float32)
    b = rng.normal(size=(N, 3)).astype(np.float32)
    a[:8] = 0.0                          # zero vectors
    a[8:16, 1] = a[8:16, 0]              # |x| == |y| ties
    a[16:24, 2] = -a[16:24, 0]           # |x| == |z| ties
    a[24, 1] = np.nan
    s = rng.uniform(-1.0, 2.0, N).astype(np.float32)
    s[:32] = 0.0
    p = rng.uniform(0.0, 50.0, N).astype(np.float32)
    p[::7] = 0.0
    m4 = rng.normal(size=(4, 4)).astype(np.float32)
    return a, b, s, p, m4


def _cases(V, mat, xp):
    """name -> function of (a, b, s, p, m4) in one package's terms."""
    return {
        "vdot": lambda a, b, s, p, m: V.vdot(a, b),
        "vcross": lambda a, b, s, p, m: V.vcross(a, b),
        "vnormalize": lambda a, b, s, p, m: V.vnormalize(b),
        "vsafe_normalize": lambda a, b, s, p, m: V.vsafe_normalize(a),
        "vmasked_normalize": lambda a, b, s, p, m: V.vmasked_normalize(
            s > 0, b),
        "vscrub_nan": lambda a, b, s, p, m: V.vscrub_nan(a),
        "vreflect": lambda a, b, s, p, m: V.vreflect(b, V.vnormalize(a)),
        "vorthonormal_u": lambda a, b, s, p, m: V.vorthonormal_u(a),
        "const_mat3_apply": lambda a, b, s, p, m: V.const_mat3_apply(m, b),
        "const_affine_apply": lambda a, b, s, p, m: V.const_affine_apply(
            m, b),
        "safe_pow": lambda a, b, s, p, m: mat.safe_pow(xp.abs(s), p),
        "safe_div": lambda a, b, s, p, m: mat.safe_div(p, s),
    }


@pytest.mark.parametrize("name", [
    "vdot", "vcross", "vnormalize", "vsafe_normalize", "vmasked_normalize",
    "vscrub_nan", "vreflect", "vorthonormal_u", "const_mat3_apply",
    "const_affine_apply", "safe_pow", "safe_div"])
def test_helper_matches_jax(name):
    import jax
    import jax.numpy as jnp

    from raytracer795_tpu.utils import vec3 as JV
    from raytracer795_tpu.utils import vecmath as JM

    from raytracer795_tpu_torch.utils import vec3 as TV
    from raytracer795_tpu_torch.utils import vecmath as TM

    a, b, s, p, m4 = _inputs(3)
    want = jax.jit(_cases(JV, JM, jnp)[name])(
        JV.Vec3.from_array(jnp.asarray(a)), JV.Vec3.from_array(jnp.asarray(b)),
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(m4))
    got = _cases(TV, TM, torch)[name](
        TV.Vec3.from_array(torch.from_numpy(a)),
        TV.Vec3.from_array(torch.from_numpy(b)),
        torch.from_numpy(s), torch.from_numpy(p), torch.from_numpy(m4))
    want = np.stack([np.asarray(c) for c in want], -1) \
        if isinstance(want, tuple) else np.asarray(want)
    got = torch.stack(tuple(got), -1).numpy() \
        if isinstance(got, tuple) else got.numpy()
    assert got.shape == want.shape
    if name in ULP_TOL:
        rtol, atol = ULP_TOL[name]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def test_sqrt_and_vnorm_are_correctly_rounded():
    """The port's square root is the correctly rounded float32 root (the
    root numpy and XLA give) at sizes where PyTorch's vectorized CPU
    kernel is up to 1 ulp off; vnorm goes through it."""
    from raytracer795_tpu_torch.utils.vec3 import Vec3, sqrt, vnorm

    x = np.random.default_rng(0).uniform(0.5, 100.0, 100_000).astype(
        np.float32)
    np.testing.assert_array_equal(sqrt(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    v = np.random.default_rng(1).normal(size=(3, 100_000)).astype(np.float32)
    want = np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    np.testing.assert_array_equal(
        vnorm(Vec3(*map(torch.from_numpy, v))).numpy(), want)
