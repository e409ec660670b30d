"""Per-lane gathers from tables, with a deterministic backward whose serial
runs stay short.

The backward of ``table[idx]`` is an accumulating ``index_put_``: on CUDA
it sorts the indices and sums each run of equal indices in one thread. A
run is as long as the number of lanes that read one row: tens of thousands
for a table of a few rows (the material tables), for a large triangle many
pixels see (a floor), or for row 0 of the triangle records, which every
miss and dead lane reads. ``gather_rows`` keeps the forward, the same
``table[idx]``, and gives its backward no run longer than about
``2 sqrt(N)`` lanes:

- a table of at most ``SMALL_ROWS`` rows sums each row's lanes with one
  masked sum (``where(idx == row, grad, 0)`` over the lanes);
- a larger table first sums the lanes of each (row, chunk of ``sqrt(N)``
  lanes) and then each row's chunk sums, two accumulating ``index_put_``.

Neither uses atomics, so two runs give the same bits, and a NaN in one
lane's gradient reaches only that lane's row, as through ``index_put_``.
"""

from __future__ import annotations

import math

import torch

# Tables of at most this many rows take the masked sum (the repo's scenes
# have 2-8 materials). Its [N, rows, C] temporary is 15 MB at 160k lanes,
# 8 rows and 3 columns.
SMALL_ROWS = 8


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` with the backward of ``gather_rows``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return row_sums(idx, grad, ctx.rows), None


def row_sums(idx, grad, rows):
    """The [rows, C] sums of the lanes' [N, C] ``grad`` by their row
    ``idx``."""
    if rows <= SMALL_ROWS:
        return _masked_sum(idx, grad, rows)
    return _chunked_sum(idx, grad, rows)


def _masked_sum(idx, grad, rows):
    rows_col = torch.arange(rows, device=idx.device)[:, None]
    named = idx[:, None, None] == rows_col              # [N, rows, 1]
    # where, not a multiply by a one-hot: 0 * NaN would put one lane's NaN
    # into every row
    return torch.where(named, grad.unsqueeze(1), 0).sum(0)


def _chunked_sum(idx, grad, rows):
    n = idx.shape[0]
    chunk = max(1, math.isqrt(n))
    n_chunks = max(1, -(-n // chunk))
    lane = torch.arange(n, device=idx.device)
    keys, inverse = torch.unique(idx.long() * n_chunks + lane // chunk,
                                 return_inverse=True)
    partial = grad.new_zeros(keys.shape + grad.shape[1:]).index_put_(
        (inverse,), grad, accumulate=True)
    return grad.new_zeros((rows,) + grad.shape[1:]).index_put_(
        (keys // n_chunks,), partial, accumulate=True)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an [N] lane index into an [M, C] table; under a
    graph, with the backward of ``_GatherRows``. Without a graph to build
    it is ``table[idx]`` itself."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)
