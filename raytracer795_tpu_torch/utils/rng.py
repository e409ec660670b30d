"""Threefry-2x32 keys and uniform draws, bit for bit those of ``jax.random``.

Counterpart of the ``jax.random`` calls of the JAX package, as jax 0.9.0
makes them with ``jax_threefry_partitionable`` on (its default):

- ``PRNGKey(s)`` is the word pair ``(0, s)`` for a 32-bit seed;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- the bits of a draw come from each element's flat index over the WHOLE
  shape, its high word one counter and its low word the other, and a
  32-bit draw is the XOR of the two output words. A draw of shape
  ``(5, P, S)`` is therefore not five draws of shape ``(P, S)``: draw the
  whole shape, as the call sites do, then slice;
- ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

A key is a pair of Python ints (two uint32 words). Deriving keys is host
integer work, so it costs no device launch; only ``uniform`` and
``random_bits`` run on a device. They compute in int64 masked to 32 bits,
so the CPU and CUDA give the same bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``.

    ``x0``/``x1`` are Python ints or int64 tensors holding uint32 values;
    the result has their type. The schedule is jax's
    ``_threefry2x32_lowering`` (jax/_src/prng.py).
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned integer")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    return threefry2x32(key, 0, data)


def random_bits(key: Key, shape, device) -> torch.Tensor:
    """32 random bits per element as an int64 tensor in [0, 2^32)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits1, bits2 = threefry2x32(key, idx >> 32, idx & MASK)
    return (bits1 ^ bits2).reshape(shape)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one_to_two - 1.0
