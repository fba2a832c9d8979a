"""Brute-force kNN-2 Hamming matching with the Lowe ratio test.

Port of kbslam/matching/hamming.py. Descriptors are unpacked {0,1}
vectors, so H(a, b) = |a| + |b| - 2 a.b is one matrix product. torch has
no int8 matmul on CUDA; the product runs on the 0/1 operands in float32
with TF32 off (kbslam_torch.device), which is exact because every sum is
at most 256. The reference narrows the masked matrix to bfloat16 — exact
for integers up to 512 — so the port keeps it in int32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# invalid-entry sentinel: above any 256-bit Hamming distance
_SENTINEL = 512


class MatchResult(NamedTuple):
    """One query set's matches, or S sets' with a leading axis."""

    best_idx: torch.Tensor     # [Nq] int32 index into the train set
    best_dist: torch.Tensor    # [Nq] int32 Hamming distance
    second_dist: torch.Tensor  # [Nq] int32 distance of the 2nd neighbour
    is_match: torch.Tensor     # [Nq] bool — passed ratio test and validity


def hamming_distance_matrix(query: torch.Tensor,
                            train: torch.Tensor) -> torch.Tensor:
    """[..., Nq, B] x [..., Nt, B] {0,1} descriptors -> [..., Nq, Nt]
    int32 distances (a batched product over leading axes: exact, since
    the operands are 0/1 and every sum is at most 256)."""
    q = query.to(torch.float32)
    t = train.to(torch.float32)
    dot = (q @ t.transpose(-1, -2)).to(torch.int32)
    nq = torch.sum(query.to(torch.int32), dim=-1, keepdim=True)
    nt = torch.sum(train.to(torch.int32), dim=-1, keepdim=True)
    return nq + nt.transpose(-1, -2) - 2 * dot


def knn2_ratio_match(query_desc: torch.Tensor, query_valid: torch.Tensor,
                     train_desc: torch.Tensor, train_valid: torch.Tensor,
                     ratio: float, cross_check: bool = False) -> MatchResult:
    """k=2 nearest neighbours + ratio test. Query = last keyframe, train
    = current frame (the reference's direction). ``cross_check`` also
    requires mutual-best agreement. Leading axes (streams) are matched
    each on its own."""
    dist = hamming_distance_matrix(query_desc, train_desc)
    d = torch.where(train_valid[..., None, :] & query_valid[..., :, None],
                    dist, _SENTINEL)
    # torch.argmin returns the first minimum, like jnp.argmin
    best = torch.amin(d, dim=-1)
    best_idx = torch.argmin(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.min(torch.where(cols == best_idx[..., None],
                                   _SENTINEL, d), dim=-1).values
    is_match = (query_valid
                & (best.to(torch.float32) < ratio * second.to(torch.float32))
                & (best < _SENTINEL))
    if cross_check:
        rev_best = torch.argmin(d, dim=-2)                  # per train col
        rows = torch.arange(d.shape[-2], device=d.device)
        is_match = is_match & (torch.gather(rev_best, -1, best_idx) == rows)
    return MatchResult(best_idx.to(torch.int32), best.to(torch.int32),
                       second.to(torch.int32), is_match)
