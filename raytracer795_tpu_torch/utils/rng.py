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

A key is a pair of uint32 words: Python ints, or 0-d int64 tensors on a
device. Deriving a key from Python ints is host integer work, so it costs
no device launch; ``uniform`` and ``random_bits`` run on a device. They
compute in int64 masked to 32 bits, so the CPU and CUDA give the same
bits, and a tensor key gives the bits of the int key with its words.

A captured program (``utils/graphs.py``) replays with other keys than the
one it was captured with, so its keys must be read from the device. A
``KeyTable`` holds them: its row 0 is the program's root key and every
other row the key of one ``fold_in`` path from it. ``fold_in`` of a table's
key finds (or adds) the row of the longer path, with no device work, and
the host writes every row's words when the root changes: the keys a
program derives cost no device launch either, where ``fold_in`` of a
tensor key would launch about 170 scalar kernels.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

Key = Union[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``.

    ``x0``/``x1`` and the key's words are Python ints or int64 tensors
    holding uint32 values; the result is a tensor where any of them is one.
    The schedule is jax's
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
    """``jax.random.fold_in(key, data)`` for ``data`` in [0, 2^32); a
    ``KeyTable``'s key gives the table's key of the longer path."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    if isinstance(key, TableKey):
        return key.table.derive(key.row, data)
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


class TableKey(tuple):
    """A ``KeyTable``'s key: the two words of one row, 0-d int64 views of
    the table on its device."""

    table: "KeyTable"
    row: int

    def __new__(cls, table: "KeyTable", row: int):
        self = super().__new__(cls, (table.words[row, 0], table.words[row, 1]))
        self.table, self.row = table, row
        return self


class KeyTable:
    """The keys a captured program derives, computed on the host and read
    on the device.

    Row 0 is the root key (``set_root``); ``derive`` gives the row of
    ``fold_in(row's key, data)``, added the first time with its words for
    the current root. ``set_root`` with another key writes every row's
    words again: on CUDA from a pinned buffer, asynchronously, in stream
    order before whatever is launched next. The words tensor grows while
    rows are added, so a program ``freeze``s the table before its capture:
    then it keeps its address, and a path never seen raises.
    """

    def __init__(self, device, rows: int = 16):
        self.device = torch.device(device)
        self.words = torch.zeros((rows, 2), dtype=torch.int64,
                                 device=self.device)
        self._parent = [-1]        # row 0, the root, has no parent
        self._data = [0]
        self._rows = {}             # (parent row, data) -> row
        self._root = (0, 0)
        self._host = None
        self._copied = None
        self._frozen = False

    def key(self) -> TableKey:
        """The root's key."""
        return TableKey(self, 0)

    def derive(self, row: int, data: int) -> TableKey:
        got = self._rows.get((row, data))
        if got is None:
            if self._frozen:
                raise RuntimeError(
                    f"a captured program derived fold_in(row {row}, {data}), "
                    "a key its warm-up did not derive")
            got = len(self._parent)
            self._rows[(row, data)] = got
            self._parent.append(row)
            self._data.append(data)
            if got == self.words.shape[0]:
                grown = torch.zeros((2 * got, 2), dtype=torch.int64,
                                    device=self.device)
                grown[:got] = self.words
                self.words = grown
            k0, k1 = fold_in(self._host_key(row), data)
            self.words[got, 0] = k0
            self.words[got, 1] = k1
        return TableKey(self, got)

    def _host_key(self, row: int):
        path = []
        while row > 0:
            path.append(self._data[row])
            row = self._parent[row]
        key = self._root
        for data in reversed(path):
            key = fold_in(key, data)
        return key

    def freeze(self):
        """No row may be added from now on: the words keep their address."""
        self._frozen = True

    def set_root(self, key: Key):
        """Make ``key`` the root and write every row's words for it."""
        key = (int(key[0]), int(key[1]))
        if key == self._root:
            return
        self._root = key
        keys = [key]
        for parent, data in zip(self._parent[1:], self._data[1:]):
            keys.append(fold_in(keys[parent], data))
        host = torch.tensor(keys, dtype=torch.int64)
        n = host.shape[0]
        if self.device.type != "cuda":
            self.words[:n] = host
            return
        if self._host is None or self._host.shape[0] < n:
            self._host = torch.empty((self.words.shape[0], 2),
                                     dtype=torch.int64, pin_memory=True)
        elif self._copied is not None:
            self._copied.synchronize()      # the last copy has read it
        self._host[:n] = host
        self.words[:n].copy_(self._host[:n], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
