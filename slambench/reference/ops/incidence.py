"""Gather and sum-by-id, the port of kbslam/ops/incidence.py.

The JAX package moves rows with one-hot incidence matmuls because
gathers are slow on the TPU. On the GPU a gather is an ``index_select``
and a sum-by-id a segment sum over the rows sorted by id; the semantics
are kept:

- ids equal to the table size (or otherwise out of range) select an
  all-zero row (gather) or are dropped (sum);
- ``exact=False`` rounds the operands through bfloat16 and sums in
  float32, as the reference's bf16 matmul with f32 accumulation does
  (kbslam/ops/incidence.py:35-37,55-57). A one-hot row has a single
  nonzero, so a gather of the bf16-rounded table is that matmul exactly.
"""
from __future__ import annotations

import torch


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def incidence_gather(ids: torch.Tensor, table: torch.Tensor,
                     exact: bool = True) -> torch.Tensor:
    """out[i] = table[ids[i]] as float32 [O, C]; out-of-range ids give
    zero rows. With a leading stream axis, ids [S, O] into tables
    [S, T, C] give [S, O, C], each stream reading its own table and its
    own zero row (one ``index_select`` over the flattened tables)."""
    values = table.to(torch.float32)
    if not exact:
        values = _bf16_round(values)
    if ids.ndim == 2:
        S, T = values.shape[:2]
        padded = torch.cat(
            [values, values.new_zeros((S, 1) + values.shape[2:])], dim=1)
        first = torch.arange(S, device=ids.device)[:, None] * (T + 1)
        safe = torch.where((ids >= 0) & (ids < T), ids, T) + first
        out = padded.reshape((-1,) + padded.shape[2:]).index_select(
            0, safe.reshape(-1))
        return out.reshape(ids.shape + padded.shape[2:])
    T = values.shape[0]
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    safe = torch.where((ids >= 0) & (ids < T), ids, T)
    return padded.index_select(0, safe)


class SumById:
    """Sums of rows by one fixed id vector: ``SumById(ids, n)(values)``
    is [n, C] float32, row t the sum of the ``values`` rows whose id is
    t; ids outside [0, n) are dropped.

    The ids are sorted once (stably) when the plan is made; each call
    gathers the rows in that order and sums every id's run from its first
    row to its last (``torch.segment_reduce``). The order of the float32
    additions is therefore fixed by the ids alone, the order a sequential
    ``index_add_`` adds in: a sum repeats bit for bit, the card's equals
    the CPU's, and a replayed CUDA graph of it equals the eager call. An
    atomic ``index_add_`` would add in an order that changes from run to
    run. Making the plan reads nothing back to the host."""

    def __init__(self, ids: torch.Tensor, n_targets: int):
        safe = torch.where((ids >= 0) & (ids < n_targets), ids,
                           n_targets).to(torch.int64)
        sorted_ids, self.order = torch.sort(safe, stable=True)
        # the first row of each id's run and, last, the end of the kept
        # rows (the dropped ids sort after every kept one)
        self.offsets = torch.searchsorted(
            sorted_ids, torch.arange(n_targets + 1, device=ids.device))

    def __call__(self, values: torch.Tensor,
                 exact: bool = False) -> torch.Tensor:
        v = values.to(torch.float32)
        if not exact:
            v = _bf16_round(v)
        return torch.segment_reduce(v.index_select(0, self.order), "sum",
                                    offsets=self.offsets, axis=0,
                                    unsafe=True, initial=0.0)


def incidence_apply(ids: torch.Tensor, n_targets: int, values: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """Sum of ``values`` rows by id: [n_targets, C] float32; ids outside
    [0, n_targets) are dropped. Float32 sums in another order than the
    reference's matmul: in the order of the rows (``SumById``)."""
    return SumById(ids, n_targets)(values, exact)
