"""Loop-closure detection and geometric verification.

Port of kbslam/loop/detect.py. A keyframe's place signature is the
L2-normalised histogram of its descriptors' vocabulary words: a word id
reads ``word_bits`` fixed bit positions of the rBRIEF descriptor as an
integer (a random-projection vocabulary, no training). Candidates are
scored by one [K, W] x [W] product over the whole ring. Verification is
the tracking step's last-keyframe path between two keyframes: a
mutual-best Hamming ratio match, then PnP-RANSAC on the candidate's
depth-unprojected points, gated by inliers and by the drift envelope.

The reference builds the word ids and histograms with one-hot matrix
products (a TPU answer to slow gathers); here a word id is a shift and
sum over the selected bits, and a histogram an integer ``scatter_add_``
of valid counts, so the counts are exact and the signatures equal the
reference's to the rounding of the norm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from kbslam_torch.geom.camera import Intrinsics, unproject
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.mapping.state import take_row
from kbslam_torch.matching.hamming import knn2_ratio_match
from kbslam_torch.pnp.ransac import Sampler, hash_sampler, ransac_pnp

# seed of the probes' minimal sets; the counter is the insertion ordinal
PROBE_SEED = 0x100B


class LoopCandidate(NamedTuple):
    found: torch.Tensor     # bool — a candidate passed the score gate
    slot: torch.Tensor      # int32 ring slot of the candidate keyframe
    score: torch.Tensor     # float32 signature similarity
    scores: torch.Tensor    # [K] all (masked) scores, for diagnostics


class LoopConstraint(NamedTuple):
    ok: torch.Tensor        # bool — geometric verification passed
    num_inliers: torch.Tensor
    rel_q: torch.Tensor     # [4] measured T_cq = T_c^-1 T_q
    rel_t: torch.Tensor     # [3]


def word_ids(desc_bits: torch.Tensor, word_bits: int) -> torch.Tensor:
    """[..., 256] {0,1} uint8 -> [...] int64 word ids in [0, 2^word_bits):
    bit k of the id is descriptor bit k * (256 // word_bits)."""
    stride = 256 // word_bits
    pos = torch.arange(word_bits, device=desc_bits.device) * stride
    bits = desc_bits.index_select(-1, pos).to(torch.int64)
    return torch.sum(bits << torch.arange(word_bits, device=desc_bits.device),
                     dim=-1)


def normalized_histogram(ids: torch.Tensor, valid: torch.Tensor,
                         word_bits: int) -> torch.Tensor:
    """[..., F] word ids and valid flags -> [..., W] L2-normalised counts."""
    W = 1 << word_bits
    counts = torch.zeros(ids.shape[:-1] + (W,), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(-1, ids, valid.to(torch.int32))
    hist = counts.to(torch.float32)
    norm = torch.sqrt(torch.clamp(torch.sum(hist * hist, -1, keepdim=True),
                                  min=1e-12))
    return hist / norm


def kf_signatures(kf_desc: torch.Tensor, kf_valid: torch.Tensor,
                  word_bits: int = 10) -> torch.Tensor:
    """[K, F, 256] bits + [K, F] valid -> [K, W] word histograms."""
    return normalized_histogram(word_ids(kf_desc, word_bits), kf_valid,
                                word_bits)


def detect_loop(m, query_slot: torch.Tensor, *, word_bits: int = 10,
                min_separation: int = 10,
                score_min: float = 0.80) -> LoopCandidate:
    """Score the query keyframe's signature against every ring slot;
    empty slots and keyframes within ``min_separation`` insertions of
    the query are masked out. The best is the first maximum."""
    sigs = kf_signatures(m.kf_desc, m.kf_kp_valid, word_bits)   # [K, W]
    scores = sigs @ take_row(sigs, query_slot)                  # [K]
    qid = take_row(m.kf_id, query_slot)
    valid = (m.kf_id >= 0) & (torch.abs(m.kf_id - qid) >= min_separation)
    scores = torch.where(valid, scores, -1.0)
    best = torch.argmax(scores).to(torch.int32)
    score = take_row(scores, best)
    return LoopCandidate(found=score >= score_min, slot=best, score=score,
                         scores=scores)


def verify_loop(m, cand_slot: torch.Tensor, query_slot: torch.Tensor,
                sampler: Sampler, intr: Intrinsics, cfg,
                min_inliers: int = 40, max_trans_disc: float = 0.30,
                max_rot_disc_deg: float = 10.0) -> LoopConstraint:
    """The candidate's points (3D from its depth) against the query's
    keypoints: mutual-best matching, PnP-RANSAC, the inlier gate and the
    drift envelope (the measured T_cq within (max_trans_disc,
    max_rot_disc_deg) of the current map's relative pose)."""
    pts3d = unproject(intr, take_row(m.kf_kp_xy, cand_slot),
                      take_row(m.kf_kp_depth, cand_slot))
    t_xy = take_row(m.kf_kp_xy, query_slot)
    t_z = take_row(m.kf_kp_depth, query_slot)
    match = knn2_ratio_match(take_row(m.kf_desc, cand_slot),
                             take_row(m.kf_kp_valid, cand_slot),
                             take_row(m.kf_desc, query_slot),
                             take_row(m.kf_kp_valid, query_slot),
                             cfg.matcher.ratio, cross_check=True)
    idx = match.best_idx.to(torch.int64)
    pts2d = t_xy.index_select(0, idx)
    depth_t = torch.where(match.is_match, t_z.index_select(0, idx), 0.0)
    pts3d_obs = unproject(intr, pts2d, depth_t)

    pnp = ransac_pnp(pts3d, pts2d, match.is_match, intr, cfg.pnp, sampler,
                     points3d_obs=pts3d_obs, obs_valid=depth_t > 0)
    ok = pnp.success & (pnp.num_inliers >= min_inliers)
    rel = pnp.T_cw.inverse().normalize()    # T_cq

    T_c = SE3(take_row(m.kf_q, cand_slot), take_row(m.kf_t, cand_slot))
    T_q = SE3(take_row(m.kf_q, query_slot), take_row(m.kf_t, query_slot))
    disc = T_c.inverse().compose(T_q).inverse().compose(rel)
    ok = (ok & (disc.translation_norm() <= max_trans_disc)
          & (torch.rad2deg(disc.rotation_angle()) <= max_rot_disc_deg))
    return LoopConstraint(ok=ok, num_inliers=pnp.num_inliers,
                          rel_q=rel.q, rel_t=rel.t)


def make_loop_probe(cfg, intr: Intrinsics, *, word_bits: int = 10,
                    min_separation: int = 10, score_min: float = 0.80,
                    min_inliers: int = 40, max_trans_disc: float = 0.30,
                    max_rot_disc_deg: float = 10.0, sampler_for=None):
    """``probe(map, query_slot, query_id, ordinal) -> (LoopCandidate,
    LoopConstraint)``: detection and the (always run, masked)
    verification, with ``constraint.ok`` folding in ``candidate.found``.
    The three arguments are 0-d int32 device tensors.

    ``query_id`` is the keyframe id the caller expects in ``query_slot``:
    the probe is a no-op when the slot no longer holds it (evicted by a
    ring wrap, or culled), so a probe drained late invalidates itself
    without a host read. The minimal sets come from ``hash_sampler(
    PROBE_SEED, ordinal)``; ``sampler_for(ordinal)`` replaces it with the
    ordinal read on the host (tests inject the reference's sets)."""

    def probe(m, query_slot, query_id, ordinal):
        cand = detect_loop(m, query_slot, word_bits=word_bits,
                           min_separation=min_separation,
                           score_min=score_min)
        fresh = take_row(m.kf_id, query_slot) == query_id
        cand = cand._replace(found=cand.found & fresh)
        sampler = (hash_sampler(PROBE_SEED, ordinal) if sampler_for is None
                   else sampler_for(int(ordinal)))
        cons = verify_loop(m, cand.slot, query_slot, sampler, intr, cfg,
                           min_inliers=min_inliers,
                           max_trans_disc=max_trans_disc,
                           max_rot_disc_deg=max_rot_disc_deg)
        return cand, cons._replace(ok=cons.ok & cand.found)

    return probe
