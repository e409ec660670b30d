"""The port's threefry RNG against ``jax.random``, bit for bit.

Keys, ``fold_in`` chains, raw 32-bit draws and ``uniform`` at odd shapes,
one of them over 2^16 elements, compared as uint32 views. The literals of
``test_literal_table`` are the ones ``chip_smoke.py`` holds the card to.
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SHAPES = [(1,), (2, 3), (5, 7, 3), (3, 23, 1000)]

# jax.random under jax 0.9.0: PRNGKey(0), fold_in(PRNGKey(0), 3) and
# uniform(fold_in(PRNGKey(0), 3), (2, 5)) as uint32 words
KEY0 = (0, 0)
KEY0_FOLD3 = (2467461003, 3840466878)
UNIFORM_2x5_BITS = [[1049146072, 1060889640, 1064576818, 1045860880,
                     1007892352],
                    [1062247070, 1064149282, 1049439860, 1063452586,
                     1064178726]]


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(key).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prng_key_matches_jax(seed):
    from raytracer795_tpu_torch.utils import rng

    assert rng.PRNGKey(seed) == _words(jax.random.PRNGKey(seed))


def test_fold_in_chain_matches_jax():
    from raytracer795_tpu_torch.utils import rng

    data = np.random.default_rng(0).integers(0, 2**32, 12, dtype=np.uint64)
    jk, pk = jax.random.PRNGKey(3), rng.PRNGKey(3)
    for d in [0, 1, 7, 1000, 7000, 2**32 - 1, *data.tolist()]:
        jk = jax.random.fold_in(jk, d)
        pk = rng.fold_in(pk, d)
        assert pk == _words(jk), d


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_match_jax(shape):
    """Raw bits first (jax.random.bits), then the floats as uint32 views."""
    from raytracer795_tpu_torch.utils import rng

    pk = rng.fold_in(rng.fold_in(rng.PRNGKey(11), 5), 2)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(11), 5), 2)
    want_bits = np.asarray(jax.random.bits(jk, shape))
    got_bits = rng.random_bits(pk, shape, "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(got_bits, want_bits)
    want = np.asarray(jax.random.uniform(jk, shape)).view(np.uint32)
    got = rng.uniform(pk, shape, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_whole_shape_draw_is_not_stacked_draws():
    """A (5, P, S) draw counts over the whole shape, so its rows differ
    from five (P, S) draws of the same key (the port slices a whole draw,
    as the JAX call sites do)."""
    from raytracer795_tpu_torch.utils import rng

    key = rng.PRNGKey(4)
    whole = rng.uniform(key, (5, 6, 4), "cpu")
    part = rng.uniform(key, (6, 4), "cpu")
    assert torch.equal(whole[0], part)
    assert not torch.equal(whole[1], part)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (5, 6, 4)))
    np.testing.assert_array_equal(whole.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_literal_table():
    """The literal values chip_smoke.py checks on the card."""
    from raytracer795_tpu_torch.utils import rng

    key = rng.PRNGKey(0)
    assert key == KEY0 == _words(jax.random.PRNGKey(0))
    k3 = rng.fold_in(key, 3)
    assert k3 == KEY0_FOLD3 == _words(jax.random.fold_in(
        jax.random.PRNGKey(0), 3))
    got = rng.uniform(k3, (2, 5), "cpu").numpy().view(np.uint32)
    want = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 3), (2, 5))).view(np.uint32)
    np.testing.assert_array_equal(got, UNIFORM_2x5_BITS)
    np.testing.assert_array_equal(want, UNIFORM_2x5_BITS)


def test_out_of_range_seed_and_data_raise():
    from raytracer795_tpu_torch.utils import rng

    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
    with pytest.raises(ValueError):
        rng.fold_in(rng.PRNGKey(0), 2**32)
