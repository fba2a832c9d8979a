"""Batched PnP-RANSAC: every hypothesis solved and scored at once.

Port of kbslam/pnp/ransac.py. Minimal sets come from a *sampler*; the
default, ``hash_sampler``, draws them from a counter-based integer hash
of ``(seed, frame_count, lane)`` in plain tensor ops (the reference's
threefry keys are not reproduced). The frame counter is a device
tensor, so a CUDA graph that replays the step draws each frame's own
sets, and the integer arithmetic gives the same indices on the CPU and
on the card. Tests pass a sampler that returns the index sets JAX draws,
so both versions solve the same hypotheses.

A sampler is called as ``sampler(valid, pool, k_dlt, k_kabsch,
set_size, packed)`` and returns ``(idx_dlt [k_dlt, set_size],
idx_kabsch [k_kabsch, set_size] or None)``: DLT sets among ``valid``
(packed: valid entries are known to come first), Kabsch sets among
``pool`` (None when there is no current-frame depth).

``ransac_pnp_batched`` runs S streams' problems at once, each with a
leading stream axis; its sampler returns [S, k, set_size] sets, each
stream's drawn among its own entries (``hash_sampler`` with a counter
per stream does so).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from slambench.reference.geom.camera import Intrinsics, project
from slambench.reference.geom.se3 import SE3, matrix_to_quat
from slambench.reference.ops.incidence import incidence_gather
from slambench.reference.pnp.dlt import normalized_rays, solve_dlt
from slambench.reference.pnp.kabsch import solve_kabsch
from slambench.reference.pnp.refine import refine_pose, refine_pose_two_stage

Sampler = Callable[..., tuple]


class PnPResult(NamedTuple):
    success: torch.Tensor       # [] bool
    T_cw: SE3                   # source (keyframe camera) -> current camera
    inlier_ratio: torch.Tensor  # [] float32 — inliers / valid matches
    inliers: torch.Tensor       # [N] bool final inlier set
    num_inliers: torch.Tensor   # [] int


_MASK32 = 0xFFFFFFFF
UNIFORM_BITS = 24


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 values
    in [0, 2^32). The multipliers are odd and below 2^31, so every
    product stays below 2^63: no int64 overflow on any device."""
    for mul in (0x7FEB352D, 0x5BD1E995, 0x27D4EB2F):
        x = x ^ (x >> 16)
        x = (x * mul) & _MASK32
    return x ^ (x >> 15)


def hash_bits(seed: int, frame_count: torch.Tensor,
              lanes: torch.Tensor) -> torch.Tensor:
    """UNIFORM_BITS uniform bits per lane (int64): a function of (seed,
    frame_count, lane) alone, equal on every device. ``frame_count``
    broadcasts against ``lanes``."""
    # the offsets keep a zero seed, frame or lane from hashing to zero
    seed_key = _mix32(torch.full_like(lanes, (seed + 0x9E3779B9) & _MASK32))
    key = _mix32(seed_key
                 ^ ((frame_count.to(torch.int64) + 0x632BE5AB) & _MASK32))
    lane = (lanes + 0x85157AF5) & _MASK32
    return _mix32(key ^ lane) >> (32 - UNIFORM_BITS)


def draw_valid_indices(bits: torch.Tensor, valid: torch.Tensor,
                       packed: bool = False) -> torch.Tensor:
    """Indices uniform among the valid entries, one per lane of ``bits``
    (int64, UNIFORM_BITS uniform bits each).

    The rank is floor(u * n_valid) with u = bits / 2^UNIFORM_BITS, taken
    in integer arithmetic, so it is exact and equal on every device;
    ``torch.randint`` would need n_valid on the host, a sync every
    frame. packed=True means the valid entries come first, so a rank is
    an index; otherwise the rank maps to the (rank+1)-th valid entry by
    the prefix count. With a leading stream axis, bits [S, k, n] draw
    among valid [S, N], each stream among its own entries."""
    lead = valid.shape[:-1]
    n_valid = torch.clamp(torch.sum(valid.to(torch.int64), dim=-1), min=1)
    n_valid = n_valid[..., None, None]
    rank = torch.minimum((bits * n_valid) >> UNIFORM_BITS, n_valid - 1)
    if packed:
        return rank
    cnt = torch.cumsum(valid.to(torch.int64), dim=-1)
    eq = ((cnt[..., None, :] == (rank.reshape(lead + (-1, 1)) + 1))
          & valid[..., None, :])
    return torch.argmax(eq.to(torch.uint8), dim=-1).reshape(rank.shape)


def hash_sampler(seed: int, frame_count: torch.Tensor) -> Sampler:
    """The default sampler of the frame ``frame_count`` (a 0-d int32
    device tensor): DLT sets on lanes [0, k_dlt * S), Kabsch sets on the
    lanes after them. A counter [S] (one per stream) gives the batched
    sampler of ``ransac_pnp_batched``: stream i's sets are those of
    ``hash_sampler(seed, frame_count[i])``."""
    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        n_d, n_k = k_dlt * set_size, k_kabsch * set_size
        lanes = torch.arange(n_d + n_k, dtype=torch.int64,
                             device=valid.device)
        lead = tuple(frame_count.shape)
        bits = hash_bits(seed, frame_count.reshape(lead + (1,)), lanes)
        idx_d = draw_valid_indices(
            bits[..., :n_d].reshape(lead + (k_dlt, set_size)), valid, packed)
        idx_k = (None if pool is None else draw_valid_indices(
            bits[..., n_d:].reshape(lead + (k_kabsch, set_size)), pool))
        return idx_d, idx_k
    return sample


def ransac_pnp(points3d: torch.Tensor, uv_obs: torch.Tensor,
               valid: torch.Tensor, intr: Intrinsics, cfg,
               sampler: Sampler,
               points3d_obs: Optional[torch.Tensor] = None,
               obs_valid: Optional[torch.Tensor] = None,
               valid_packed: bool = False) -> PnPResult:
    """points3d [N, 3] (keyframe camera), uv_obs [N, 2] (current image),
    valid [N] bool. With current-frame depth (points3d_obs, obs_valid)
    all but ``dlt_fraction`` of the hypotheses come from the 3D-3D
    Kabsch solver; all are polished and scored by 2D reprojection."""
    K = cfg.num_hypotheses
    S = cfg.sample_size
    n_valid = torch.sum(valid.to(torch.int32))

    if points3d_obs is not None:
        K_dlt = max(int(K * cfg.dlt_fraction), 1)
        both = valid & obs_valid
        # sample `valid` when depth is missing everywhere
        pool = torch.where(torch.any(both), both, valid)
        idx_d, idx_k = sampler(valid, pool, K_dlt, K - K_dlt, S, valid_packed)
        idx = torch.cat([idx_d.to(torch.int64), idx_k.to(torch.int64)])
        tab = torch.cat([points3d, uv_obs, points3d_obs], dim=1)
    else:
        K_dlt = K
        idx, _ = sampler(valid, None, K, 0, S, valid_packed)
        idx = idx.to(torch.int64)
        tab = torch.cat([points3d, uv_obs], dim=1)

    rows = incidence_gather(idx.reshape(-1), tab).reshape(K, S, -1)
    pts_s = rows[..., :3]                                # [K, S, 3]
    uv_s = rows[..., 3:5]                                # [K, S, 2]
    R, t = solve_dlt(pts_s[:K_dlt], normalized_rays(intr, uv_s[:K_dlt]))
    if points3d_obs is not None:
        R_k, t_k = solve_kabsch(pts_s[K_dlt:], rows[K_dlt:, :, 5:8])
        R = torch.cat([R, R_k])
        t = torch.cat([t, t_k])

    # polish every hypothesis with GN on its own minimal set
    T_init = SE3(matrix_to_quat(R), t).normalize()
    ones_s = torch.ones(S, dtype=points3d.dtype, device=points3d.device)
    T_h = refine_pose(T_init, pts_s, uv_s, ones_s, intr,
                      iters=cfg.polish_iters)

    # score every hypothesis against every correspondence: [K, N]
    Rh = T_h.rotation_matrix()
    pc = torch.einsum("kij,nj->kni", Rh, points3d) + T_h.t[:, None, :]
    uv_proj, z = project(intr, pc)
    err2 = torch.sum((uv_proj - uv_obs[None]) ** 2, dim=-1)
    thr2 = cfg.reproj_threshold * cfg.reproj_threshold
    inlier = (err2 < thr2) & (z > 0) & valid[None, :]
    finite = (torch.all(torch.isfinite(T_h.q), dim=-1)
              & torch.all(torch.isfinite(T_h.t), dim=-1))
    counts = torch.where(finite, torch.sum(inlier, dim=1), 0)
    # first maximum, like jnp.argmax; selected with index_select, since
    # indexing with a 0-d tensor would read it on the host
    best = torch.argmax(counts).reshape(1)
    T0 = SE3(T_h.q.index_select(0, best)[0],
             T_h.t.index_select(0, best)[0]).normalize()

    # polish on the inlier set, then on its sub-2px subset
    T = refine_pose_two_stage(T0, points3d, uv_obs,
                              inlier.index_select(0, best)[0].to(torch.float32),
                              valid, intr, iters=cfg.refine_iters,
                              wide_thr2=thr2)

    # recount with the polished pose (8 px gate for the ratio)
    uv_fin, z_fin = project(intr, T.apply(points3d))
    err2_fin = torch.sum((uv_fin - uv_obs) ** 2, dim=-1)
    final_inliers = (err2_fin < thr2) & (z_fin > 0) & valid
    num_inliers = torch.sum(final_inliers)

    ok = ((num_inliers >= cfg.min_inliers) & (n_valid >= cfg.min_points)
          & torch.all(torch.isfinite(T.q)) & torch.all(torch.isfinite(T.t)))
    ratio = num_inliers.to(torch.float32) / torch.clamp(
        n_valid.to(torch.float32), min=1.0)
    identity = SE3.identity(dtype=T.t.dtype, device=T.t.device)
    T_safe = SE3(torch.where(ok, T.q, identity.q),
                 torch.where(ok, T.t, identity.t))
    return PnPResult(ok, T_safe, torch.where(ok, ratio, 0.0), final_inliers,
                     num_inliers)


def _hypotheses(rows: torch.Tensor, K_dlt: int, intr: Intrinsics,
                cfg) -> SE3:
    """The polished hypotheses [B, K] of B problems' minimal-set rows
    [B, K, S, 8] (points, pixels, current-frame points): DLT on the first
    ``K_dlt`` sets, Kabsch on the rest, every one polished by GN on its
    own set, all B x K as one batch."""
    B, K, S = rows.shape[:3]
    rows_d = rows[:, :K_dlt].reshape(B * K_dlt, S, -1)
    rows_k = rows[:, K_dlt:].reshape(B * (K - K_dlt), S, -1)
    R_d, t_d = solve_dlt(rows_d[..., :3], normalized_rays(intr,
                                                          rows_d[..., 3:5]))
    R_k, t_k = solve_kabsch(rows_k[..., :3], rows_k[..., 5:8])
    R = torch.cat([R_d.reshape(B, K_dlt, 3, 3),
                   R_k.reshape(B, K - K_dlt, 3, 3)], dim=1)
    t = torch.cat([t_d.reshape(B, K_dlt, 3),
                   t_k.reshape(B, K - K_dlt, 3)], dim=1)
    T_init = SE3(matrix_to_quat(R.reshape(-1, 3, 3)),
                 t.reshape(-1, 3)).normalize()
    flat = rows.reshape(B * K, S, -1)
    ones_s = torch.ones(S, dtype=rows.dtype, device=rows.device)
    T_h = refine_pose(T_init, flat[..., :3], flat[..., 3:5], ones_s, intr,
                      iters=cfg.polish_iters)
    return SE3(T_h.q.reshape(B, K, 4), T_h.t.reshape(B, K, 3))


def ransac_pnp_batched(points3d: torch.Tensor, uv_obs: torch.Tensor,
                       valid: torch.Tensor, intr: Intrinsics, cfg,
                       sampler: Sampler, points3d_obs: torch.Tensor,
                       obs_valid: torch.Tensor,
                       valid_packed: bool = False) -> PnPResult:
    """``ransac_pnp`` (with current-frame depth, valid entries packed
    first, as the step's top-M compaction leaves them) for S streams at
    once: points3d [S, N, 3], uv_obs [S, N, 2], valid [S, N], and the
    depth terms likewise -> a PnPResult with a leading S on every field.

    On CUDA the S x K hypotheses are solved and polished as one batch
    of S * K; scoring, the winner (the first maximum) and the final
    polish are per stream. On the CPU every stream's result equals
    ``ransac_pnp`` on its own problem bit for bit, for S under 16 (the
    S final poses are one batch, whose pow, sin and cos stay in the
    vector's scalar tail only while S is under the CPU's vector width)."""
    S_n, N = valid.shape
    K = cfg.num_hypotheses
    S = cfg.sample_size
    n_valid = torch.sum(valid.to(torch.int32), dim=-1)

    K_dlt = max(int(K * cfg.dlt_fraction), 1)
    both = valid & obs_valid
    # sample `valid` when depth is missing everywhere in the stream
    pool = torch.where(torch.any(both, dim=-1, keepdim=True), both, valid)
    idx_d, idx_k = sampler(valid, pool, K_dlt, K - K_dlt, S, True)
    idx = torch.cat([idx_d.to(torch.int64), idx_k.to(torch.int64)], dim=1)
    tab = torch.cat([points3d, uv_obs, points3d_obs], dim=-1)

    rows = incidence_gather(idx.reshape(S_n, -1), tab).reshape(S_n, K, S, -1)
    if rows.device.type == "cpu":
        # the CPU's vectorized pow, sin and cos round otherwise in a
        # vector's body than in its tail, so a batch of S x K would give a
        # stream's hypotheses other bits than its own batch of K: each
        # stream is solved in the batch ``ransac_pnp`` solves
        parts = [_hypotheses(rows[i:i + 1], K_dlt, intr, cfg)
                 for i in range(S_n)]
        T_h = SE3(torch.cat([p.q for p in parts]),
                  torch.cat([p.t for p in parts]))
    else:
        T_h = _hypotheses(rows, K_dlt, intr, cfg)

    # score every hypothesis against its stream's correspondences
    Rh = T_h.rotation_matrix()
    pc = (torch.einsum("skij,snj->skni", Rh, points3d)
          + T_h.t[:, :, None, :])
    uv_proj, z = project(intr, pc)
    err2 = torch.sum((uv_proj - uv_obs[:, None]) ** 2, dim=-1)
    thr2 = cfg.reproj_threshold * cfg.reproj_threshold
    inlier = (err2 < thr2) & (z > 0) & valid[:, None, :]
    finite = (torch.all(torch.isfinite(T_h.q), dim=-1)
              & torch.all(torch.isfinite(T_h.t), dim=-1))
    counts = torch.where(finite, torch.sum(inlier, dim=-1), 0)
    # each stream's first maximum, gathered on the device
    best = torch.argmax(counts, dim=-1)                  # [S_n]
    pick = torch.arange(S_n, device=best.device) * K + best
    T0 = SE3(T_h.q.reshape(-1, 4).index_select(0, pick),
             T_h.t.reshape(-1, 3).index_select(0, pick)).normalize()
    w0 = inlier.reshape(S_n * K, N).index_select(0, pick)

    # polish on the inlier set, then on its sub-2px subset
    T = refine_pose_two_stage(T0, points3d, uv_obs, w0.to(torch.float32),
                              valid, intr, iters=cfg.refine_iters,
                              wide_thr2=thr2)

    # recount with the polished pose (8 px gate for the ratio)
    uv_fin, z_fin = project(intr, SE3(T.q[:, None], T.t[:, None]).apply(
        points3d))
    err2_fin = torch.sum((uv_fin - uv_obs) ** 2, dim=-1)
    final_inliers = (err2_fin < thr2) & (z_fin > 0) & valid
    num_inliers = torch.sum(final_inliers, dim=-1)

    ok = ((num_inliers >= cfg.min_inliers) & (n_valid >= cfg.min_points)
          & torch.all(torch.isfinite(T.q), dim=-1)
          & torch.all(torch.isfinite(T.t), dim=-1))
    ratio = num_inliers.to(torch.float32) / torch.clamp(
        n_valid.to(torch.float32), min=1.0)
    identity = SE3.identity(dtype=T.t.dtype, device=T.t.device)
    T_safe = SE3(torch.where(ok[:, None], T.q, identity.q),
                 torch.where(ok[:, None], T.t, identity.t))
    return PnPResult(ok, T_safe, torch.where(ok, ratio, 0.0), final_inliers,
                     num_inliers)
