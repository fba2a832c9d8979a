"""Global bundle adjustment over a whole map (BASELINE.json config 5:
200 keyframes / 50k landmarks), on one device or over a process group.

Port of kbslam/ba/global_ba.py. The reduced camera system
S = H_cc - U H_pp^-1 U^T is never formed: preconditioned conjugate
gradients (PCG) apply it matrix-free, with the block-Jacobi
(SCHUR_JACOBI) preconditioner on S's 6x6 diagonal blocks. Camera 0 of
the problem, or whichever has ``cam_free`` False, is held fixed;
``anchor_mp`` pins the scale.

Sharding (``group``, a ``parallel.dist.ShardGroup``; ``None`` is one
device): as in the reference's ``shard_map``, each rank holds its block
of the cameras and their observations (``shard_global_data``) and a copy
of the landmarks. The landmark sums of the camera blocks are all-reduced
(``psum``), and so are the costs and PCG's two dot products. With
``landmark_sharded`` the landmark normal equations are reduce-scattered
instead (``psum_scatter``): each rank inverts its block of the [P, 3, 3]
landmark blocks, and the landmark-side vectors are all-gathered where
the cameras need them (``all_gather``). Every collective runs in every
trip whatever the data, and every mask derives from a summed value, so
the ranks stay in step.

- Sums by landmark id are segment sums over one plan per solve
  (``ops.incidence.SumById``, unrounded): the ids do not change within a
  solve, and the sums add in a fixed order, so a solve repeats bit for
  bit and a replayed CUDA graph of it equals the eager solve.
- 3x3 inverses by the adjugate (``compact_lm.inv3x3``), 6x6 by
  ``torch.linalg.inv_ex`` without its error check, which would read the
  device from the host; both with the reference's 1e-8 floors.
- The reference's two ``while_loop``s (PCG's early stop at
  ``rz <= pcg_tol^2 rz0``, and the damping retries until the trial cost
  drops) run here to their caps, every update masked once the loop's
  condition fails. The counters (PCG iterations, retries) count only
  the live trips, as the reference's do. So a solve makes no host read
  and can be captured as one CUDA graph, at the price of running
  ``iters x max_retries x pcg_iters`` applications of S whatever the
  data (``GlobalBAStats`` says how many were live).

TF32 stays off (``device.pick_device``), the counterpart of the
reference's ``default_matmul_precision("highest")``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from kbslam_torch.ba.compact_lm import inv3x3
from kbslam_torch.ba.problem import build_problem
from kbslam_torch.device import Replayed
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.geom.se3 import SE3, cross_matrix, quat_conj, quat_to_matrix
from kbslam_torch.mapping.state import scatter_rows
from kbslam_torch.ops.incidence import SumById
from kbslam_torch.parallel.dist import ShardGroup

# depth clamp for observations whose landmark moves behind the camera:
# the residual stays finite and large (the LM guard rejects such steps)
# while the Jacobian weight is zeroed
_MIN_Z = 1e-2


class GlobalBAData(NamedTuple):
    """Camera-major observation layout, padded (the reference's)."""

    cam_q: torch.Tensor     # [C, 4] T_wc
    cam_t: torch.Tensor     # [C, 3]
    obs_uv: torch.Tensor    # [C, F, 2]
    mp_id: torch.Tensor     # [C, F] int32 landmark slot (-1 = none)
    active: torch.Tensor    # [C, F] bool
    w_z: torch.Tensor       # [C, F] fixed robust/depth weights
    z_meas: torch.Tensor    # [C, F] measured keypoint depth (m; 0 = none)
    w_d: torch.Tensor       # [C, F] depth-residual weight 1/sigma^2
    cam_free: torch.Tensor  # [C] bool (False: gauge-fixed or padding)
    mp_pos: torch.Tensor    # [P, 3] landmarks
    anchor_mp: torch.Tensor  # [] int32 scale-anchor landmark (-1 = none)


class GlobalBAStats(NamedTuple):
    """Per-round record of the LM solve (all [iters])."""

    costs: torch.Tensor      # accepted cost after each round
    accepted: torch.Tensor   # bool: the round found a descent step
    retries: torch.Tensor    # int32 damping levels tried in the round
    pcg_iters: torch.Tensor  # int32 live PCG trips across the retries
    lam: torch.Tensor        # damping after each round


class _Reduce(NamedTuple):
    """The reference's collectives of one solve, the identity on one
    device: ``total`` sums a camera block's partial over the ranks,
    ``lm`` reduces the [P, ...] landmark sums (all-reduce, or reduce-
    scatter to this rank's [P/W, ...] rows with landmark sharding),
    ``full`` gathers landmark rows back to [P, ...], and ``first`` is
    the id of this rank's first landmark row."""
    total: Callable
    lm: Callable
    full: Callable
    first: int


def _identity(t):
    return t


def _reduce(group: Optional[ShardGroup], landmark_sharded: bool,
            n_points: int) -> _Reduce:
    """The collectives of a solve over ``group``; raises ``ValueError``,
    before any collective, when landmark sharding cannot split the
    ``n_points`` landmarks evenly."""
    if group is None:
        return _Reduce(_identity, _identity, _identity, 0)
    if not landmark_sharded:
        return _Reduce(group.sum, group.sum, _identity, 0)
    first, _ = group.rows(n_points, "landmarks (landmark_sharded)")
    return _Reduce(group.sum, group.sum_scatter, group.gather, first)


def _gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[clip(ids, 0)] for ids of any shape, by one index_select."""
    flat = torch.clamp(ids, min=0).reshape(-1).to(torch.int64)
    return table.index_select(0, flat).reshape(ids.shape + table.shape[1:])


def _depth_row_terms(z, z_meas, w_d, active, delta):
    """The RGB-D depth row: unwhitened residual, IRLS weight and robust
    cost (``delta`` the Huber threshold on the whitened residual)."""
    r_z = z - z_meas
    rw = torch.abs(torch.sqrt(w_d) * r_z)
    w_hub = torch.clamp(delta / torch.clamp(rw, min=1e-18), max=1.0)
    cost = torch.sum(torch.where(rw <= delta, rw * rw,
                                 2.0 * delta * rw - delta * delta) * active)
    return r_z, w_d * w_hub * active, cost


def _project(cam_q, cam_t, obs_uv, mp_id, mp_pos, intr):
    """(landmark X, camera point pc, clamped depth z, residual r)."""
    X = _gather_rows(mp_pos, mp_id)                            # [C, F, 3]
    pc = SE3(cam_q[:, None, :], cam_t[:, None, :]).inverse().apply(X)
    z = torch.clamp(pc[..., 2], min=_MIN_Z)
    u = intr.fx * pc[..., 0] / z + intr.cx
    v = intr.fy * pc[..., 1] / z + intr.cy
    return X, pc, z, torch.stack([u, v], dim=-1) - obs_uv


def _huber_cost(n, w_z, active, delta):
    return torch.sum(w_z * torch.where(n <= delta, n * n,
                                       2.0 * delta * n - delta * delta)
                     * active)


def _per_obs_terms(d: GlobalBAData, intr: Intrinsics, depth_rows: bool,
                   delta: float):
    """Residuals, per-row IRLS weights and Jacobian blocks; rows are
    (u, v) or (u, v, depth) with ``depth_rows``."""
    X, pc, z, r = _project(d.cam_q, d.cam_t, d.obs_uv, d.mp_id, d.mp_pos,
                           intr)
    active = d.active.to(torch.float32)
    in_front = (pc[..., 2] > _MIN_Z).to(torch.float32)
    n = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-18))
    w = d.w_z * torch.clamp(delta / n, max=1.0) * active * in_front

    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    J_proj = torch.stack([
        torch.stack([intr.fx * inv_z, zero,
                     -intr.fx * pc[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, intr.fy * inv_z,
                     -intr.fy * pc[..., 1] * inv_z * inv_z], -1),
    ], dim=-2)                                                 # [C, F, 2, 3]
    cost = _huber_cost(n, d.w_z, active, delta)
    w_rows = torch.stack([w, w], dim=-1)                       # [C, F, R]
    if depth_rows:
        r_z, w_dr, cost_d = _depth_row_terms(z, d.z_meas, d.w_d, active,
                                             delta)
        cost = cost + cost_d
        row_z = torch.stack([zero, zero, torch.ones_like(z)], -1)
        J_proj = torch.cat([J_proj, row_z[..., None, :]], dim=-2)
        r = torch.cat([r, r_z[..., None]], dim=-1)
        w_rows = torch.cat([w_rows, (w_dr * in_front)[..., None]], dim=-1)
    R_cw = quat_to_matrix(quat_conj(d.cam_q))
    J_pt = torch.einsum("cfab,cbd->cfad", J_proj, R_cw)        # [C, F, R, 3]
    J_cam = torch.cat(
        [-J_pt, torch.einsum("cfab,cfbd->cfad", J_pt, cross_matrix(X))],
        dim=-1)                                                # [C, F, R, 6]
    return r, w_rows, J_cam, J_pt, cost


def _robust_cost(cam_q, cam_t, mp_pos, d: GlobalBAData, intr, depth_rows,
                 delta):
    """The robust cost alone, the cheap half of the LM accept test."""
    _, _, z, r = _project(cam_q, cam_t, d.obs_uv, d.mp_id, mp_pos, intr)
    active = d.active.to(torch.float32)
    n = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-18))
    cost = _huber_cost(n, d.w_z, active, delta)
    if depth_rows:
        cost = cost + _depth_row_terms(z, d.z_meas, d.w_d, active, delta)[2]
    return cost


class _Linearization(NamedTuple):
    """The damping-independent normal equations of one round (landmark
    rows: all P, or this rank's P/W with landmark sharding)."""
    cost0: torch.Tensor
    H_pp: torch.Tensor   # [P, 3, 3]
    b_p: torch.Tensor    # [P, 3]
    p_act: torch.Tensor  # [P] bool: free landmark with an observation
    H_cc: torch.Tensor   # [C, 6, 6]
    b_c: torch.Tensor    # [C, 6]
    U: torch.Tensor      # [C, F, 6, 3]


def _linearize(d: GlobalBAData, intr, depth_rows, delta,
               sum_p: SumById, red: _Reduce) -> _Linearization:
    r, w, J_cam, J_pt, cost0 = _per_obs_terms(d, intr, depth_rows, delta)
    C, F = d.mp_id.shape
    Hp_obs = torch.einsum("cfri,cfr,cfrj->cfij", J_pt, w, J_pt)
    bp_obs = -torch.einsum("cfri,cfr,cfr->cfi", J_pt, w, r)
    ones = torch.ones((C * F, 1), dtype=torch.float32, device=r.device)
    lm = red.lm(sum_p(torch.cat([Hp_obs.reshape(-1, 9),
                                 bp_obs.reshape(-1, 3), ones], dim=1),
                      exact=True))
    P = lm.shape[0]
    p_ids = red.first + torch.arange(P, device=r.device)
    p_act = (lm[:, 12] > 0) & (p_ids != d.anchor_mp)
    maskc = d.cam_free.to(torch.float32)
    H_cc = torch.einsum("cfri,cfr,cfrj->cij", J_cam, w, J_cam)
    b_c = -torch.einsum("cfri,cfr,cfr->ci", J_cam, w, r) * maskc[:, None]
    U = torch.einsum("cfri,cfr,cfrj->cfij", J_cam, w, J_pt)
    U = U * maskc[:, None, None, None]
    return _Linearization(red.total(cost0), lm[:, :9].reshape(P, 3, 3),
                          lm[:, 9:12], p_act, H_cc, b_c, U)


def _damped_solve(lin: _Linearization, d: GlobalBAData, lam, sum_p: SumById,
                  pcg_iters: int, pcg_tol: float, early_stop: bool,
                  red: _Reduce):
    """The damped system of the cached linearization, solved by PCG:
    (delta_c, delta_p [P, 3], live PCG trips). ``early_stop`` masks the
    trips after ``rz <= pcg_tol^2 rz0``; without it all ``pcg_iters``
    run."""
    dev = lin.H_cc.device
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    act = d.active.to(torch.float32)[..., None]                # [C, F, 1]
    maskc = d.cam_free.to(torch.float32)
    dscale = 1.0 + lam
    H_pp_d = lin.H_pp * eye3 * dscale + lin.H_pp * (1 - eye3)
    H_pp_d = H_pp_d + 1e-8 * eye3
    Hpp_inv = inv3x3(H_pp_d) * lin.p_act.to(torch.float32)[:, None, None]
    H_cc_d = lin.H_cc * dscale * eye6 + lin.H_cc * (1 - eye6)
    U = lin.U

    # reduced right-hand side b~ = b_c - U Hpp^-1 b_p
    Hib = red.full(torch.einsum("pij,pj->pi", Hpp_inv, lin.b_p))
    b_t = lin.b_c - torch.einsum("cfij,cfj->ci", U,
                                 _gather_rows(Hib, d.mp_id) * act)

    # SCHUR_JACOBI: the 6x6 diagonal blocks of S, floored so that a free
    # camera with no active observation does not NaN every dot product
    HiU = torch.einsum("cfkj,cfjl->cfkl", U,
                       _gather_rows(red.full(Hpp_inv), d.mp_id)
                       * act[..., None])
    S_diag = H_cc_d - torch.einsum("cfkl,cfml->ckm", HiU, U)
    S_diag = S_diag + (1.0 - maskc)[:, None, None] * eye6
    S_diag = S_diag + 1e-8 * eye6
    M_inv = torch.linalg.inv_ex(S_diag).inverse

    def S_apply(x):
        x = x * maskc[:, None]
        t1 = torch.einsum("cij,cj->ci", H_cc_d, x)
        UTx = torch.einsum("cfij,ci->cfj", U, x) * act        # [C, F, 3]
        v = red.lm(sum_p(UTx.reshape(-1, 3), exact=True))
        wv = red.full(torch.einsum("pij,pj->pi", Hpp_inv, v))
        t2 = torch.einsum("cfij,cfj->ci", U, _gather_rows(wv, d.mp_id) * act)
        return (t1 - t2) * maskc[:, None]

    def precond(v):
        return torch.einsum("cij,cj->ci", M_inv, v)

    x = torch.zeros_like(b_t)
    rr = b_t
    z = precond(rr)
    p = z
    rz = red.total(torch.sum(rr * z))
    stop = pcg_tol * pcg_tol * rz
    k = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(pcg_iters):
        Ap = S_apply(p)
        alpha = rz / torch.clamp(red.total(torch.sum(p * Ap)), min=1e-20)
        x_n = x + alpha * p
        rr_n = rr - alpha * Ap
        z_n = precond(rr_n)
        rz_n = red.total(torch.sum(rr_n * z_n))
        beta = rz_n / torch.clamp(rz, min=1e-20)
        p_n = z_n + beta * p
        if early_stop:
            live = rz > stop
            x, rr, z, p, rz = (torch.where(live, a, b) for a, b in
                               zip((x_n, rr_n, z_n, p_n, rz_n),
                                   (x, rr, z, p, rz)))
            k = k + live.to(torch.int32)
        else:
            x, rr, z, p, rz = x_n, rr_n, z_n, p_n, rz_n
            k = k + 1
    delta_c = x * maskc[:, None]

    # landmark back-substitution
    UTd = torch.einsum("cfij,ci->cfj", U, delta_c) * act
    v = red.lm(sum_p(UTd.reshape(-1, 3), exact=True))
    delta_p = red.full(torch.einsum("pij,pj->pi", Hpp_inv, lin.b_p - v)
                       * lin.p_act.to(torch.float32)[:, None])
    return delta_c, delta_p, k


def _trial_point(d: GlobalBAData, delta_c, delta_p):
    T_new = SE3.exp(delta_c).compose(SE3(d.cam_q, d.cam_t)).normalize()
    free = d.cam_free[:, None]
    return (torch.where(free, T_new.q, d.cam_q),
            torch.where(free, T_new.t, d.cam_t), d.mp_pos + delta_p)


def _landmark_plan(d: GlobalBAData) -> SumById:
    """The sums by landmark of one solve: inactive rows go to the dropped
    id P."""
    P = d.mp_pos.shape[0]
    return SumById(torch.where(d.active, d.mp_id, P).reshape(-1), P)


def global_ba_step(data: GlobalBAData, intr: Intrinsics, pcg_iters: int = 30,
                   damping: float = 1e-4, depth_rows: bool = False,
                   huber_delta: float = 1.0,
                   group: Optional[ShardGroup] = None):
    """One damped Gauss-Newton step with ``pcg_iters`` PCG trips. Returns
    (updated data, pre-step robust cost). Unguarded: the step is applied
    even when it raises the cost; prefer ``global_ba_solve``. Over a
    ``group``, ``data`` is this rank's camera block
    (``shard_global_data``), and so are the returned cameras."""
    red = _reduce(group, False, data.mp_pos.shape[0])
    sum_p = _landmark_plan(data)
    lin = _linearize(data, intr, depth_rows, huber_delta, sum_p, red)
    lam = torch.full((), damping, dtype=torch.float32,
                     device=data.cam_q.device)
    delta_c, delta_p, _ = _damped_solve(lin, data, lam, sum_p, pcg_iters,
                                        0.0, False, red)
    q, t, mp = _trial_point(data, delta_c, delta_p)
    return data._replace(cam_q=q, cam_t=t, mp_pos=mp), lin.cost0


def _lm_round(d: GlobalBAData, lam, intr, depth_rows, delta, sum_p,
              pcg_iters, pcg_tol, max_retries, red: _Reduce):
    """One Levenberg-Marquardt round: linearize once, then retry the
    damped solve with growing damping until the trial cost drops below
    the round's start (at most ``max_retries`` levels; the trips after
    an accepted level are masked). Returns (data at the accepted point,
    lam, cost0, accepted cost, accepted, tries, live PCG trips)."""
    lin = _linearize(d, intr, depth_rows, delta, sum_p, red)
    dev = lin.cost0.device
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    tries = torch.zeros((), dtype=torch.int32, device=dev)
    pcg_used = torch.zeros((), dtype=torch.int32, device=dev)
    nq, nt, nmp, ncost = d.cam_q, d.cam_t, d.mp_pos, lin.cost0
    for _ in range(max_retries):
        live = ~accepted
        delta_c, delta_p, k = _damped_solve(lin, d, lam, sum_p, pcg_iters,
                                            pcg_tol, True, red)
        tq, tt, tmp = _trial_point(d, delta_c, delta_p)
        tcost = red.total(_robust_cost(tq, tt, tmp, d, intr, depth_rows,
                                       delta))
        acc = live & (tcost < lin.cost0)
        nq, nt, nmp, ncost = (torch.where(acc, a, b) for a, b in
                              zip((tq, tt, tmp, tcost), (nq, nt, nmp, ncost)))
        lam_n = torch.where(acc, torch.clamp(lam / 3.0, min=1e-8),
                            torch.clamp(lam * 4.0, max=1e5))
        lam = torch.where(live, lam_n, lam)
        accepted = accepted | acc
        tries = tries + live.to(torch.int32)
        pcg_used = pcg_used + torch.where(live, k, 0)
    return (d._replace(cam_q=nq, cam_t=nt, mp_pos=nmp), lam, lin.cost0,
            ncost, accepted, tries, pcg_used)


def global_ba_solve(data: GlobalBAData, intr: Intrinsics, iters: int = 5,
                    pcg_iters: int = 30, init_damping: float = 1e-4,
                    depth_rows: bool = False, huber_delta: float = 1.0,
                    pcg_tol: float = 1e-2, max_retries: int = 4,
                    return_stats: bool = False,
                    group: Optional[ShardGroup] = None,
                    landmark_sharded: bool = False):
    """LM-guarded global BA: ``iters`` trust-region rounds, each
    linearizing once and retrying growing damping on rejection, PCG
    stopping at relative residual ``pcg_tol`` (``pcg_iters`` is the cap).
    Returns (data, costs [iters + 1]): costs[0] the initial robust cost,
    costs[i + 1] the accepted cost after round i (flat where no damping
    level descended), non-increasing by construction; with
    ``return_stats`` also ``GlobalBAStats``. Makes no host read.

    Over a ``group``, ``data`` is this rank's camera block
    (``shard_global_data``) and so are the returned cameras; landmarks,
    costs and stats are every rank's. ``landmark_sharded`` reduce-
    scatters the landmark normal equations (P divisible by the world
    size, else ``ValueError``); without a group it changes nothing."""
    red = _reduce(group, landmark_sharded, data.mp_pos.shape[0])
    sum_p = _landmark_plan(data)
    lam = torch.full((), init_damping, dtype=torch.float32,
                     device=data.cam_q.device)
    cost0, hist, accs, rets, pcgs, lams = None, [], [], [], [], []
    for _ in range(iters):
        data, lam, c0, ncost, acc, tries, used = _lm_round(
            data, lam, intr, depth_rows, huber_delta, sum_p, pcg_iters,
            pcg_tol, max_retries, red)
        cost0 = c0 if cost0 is None else cost0
        hist.append(ncost)
        accs.append(acc)
        rets.append(tries)
        pcgs.append(used)
        lams.append(lam)
    costs = torch.stack([cost0] + hist)
    if not return_stats:
        return data, costs
    return data, costs, GlobalBAStats(costs[1:], torch.stack(accs),
                                      torch.stack(rets), torch.stack(pcgs),
                                      torch.stack(lams))


# the fields with a leading camera axis (the rest are every rank's)
_CAMERA_FIELDS = 9


def shard_global_data(data: GlobalBAData, group: ShardGroup) -> GlobalBAData:
    """This rank's block of the cameras and their observations, with the
    landmarks and the anchor kept whole: the reference's ``device_put``
    with the camera sharding. Raises ``ValueError`` when the cameras do
    not split evenly over the ranks."""
    return GlobalBAData(*(group.block(x) for x in data[:_CAMERA_FIELDS]),
                        *data[_CAMERA_FIELDS:])


def gather_global_data(data: GlobalBAData, group: ShardGroup) -> GlobalBAData:
    """Every rank's camera block stacked in rank order: the whole problem
    on every rank (the inverse of ``shard_global_data``)."""
    return GlobalBAData(*(group.gather(x) for x in data[:_CAMERA_FIELDS]),
                        *data[_CAMERA_FIELDS:])


def dryrun_sharded_global_ba(group: ShardGroup) -> None:
    """The reference's multi-device smoke check: a synthetic problem of
    max(8, W) cameras, camera-sharded over ``group``, 2 guarded rounds of
    at most 10 PCG trips; raises unless the costs and cameras are finite
    and the last cost is no higher than the first."""
    data, intr, _ = make_synthetic_global_problem(
        np.random.default_rng(0), group.device, n_cams=max(8, group.world))
    out, costs = global_ba_solve(shard_global_data(data, group), intr,
                                 iters=2, pcg_iters=10, group=group)
    costs = costs.cpu()
    if not bool(torch.isfinite(costs).all()):
        raise AssertionError(f"global BA cost not finite: {costs}")
    if not bool(torch.isfinite(out.cam_t).all()):
        raise AssertionError("global BA produced NaNs")
    if not bool(costs[-1] <= costs[0]):
        raise AssertionError(f"LM guard failed to be monotone: {costs}")


def make_global_solve(intr: Intrinsics, iters: int, pcg_iters: int,
                      depth_rows: bool, huber_delta: float,
                      group: Optional[ShardGroup] = None,
                      landmark_sharded: bool = False):
    """``solve(data) -> (data, costs)``: ``global_ba_solve`` with these
    settings bound, the function ``slam.run_global_ba_on_map`` runs (on
    CUDA through ``replayed_global_solve``)."""
    def solve(data):
        return global_ba_solve(data, intr, iters=iters, pcg_iters=pcg_iters,
                               depth_rows=depth_rows, huber_delta=huber_delta,
                               group=group, landmark_sharded=landmark_sharded)
    return solve


def replayed_global_solve(intr: Intrinsics, iters: int, pcg_iters: int,
                          depth_rows: bool, huber_delta: float,
                          group: Optional[ShardGroup] = None,
                          landmark_sharded: bool = False) -> Replayed:
    """``make_global_solve``'s solve on CUDA as one CUDA graph per problem
    shape (``device.Replayed``), keyed by the settings and the world size
    and kept in the group's ``graphs`` (or the process's, without a
    group): the counterpart of the reference's one jitted program per
    shape. The first solve at a shape runs eagerly and warms the capture
    up; the second captures and replays, later ones replay. Over an NCCL
    group the graph holds the solve's collectives: every rank captures
    the same sequence, after the eager solve's collectives have set up
    the communicator."""
    world = 1 if group is None else group.world
    settings = (iters, pcg_iters, depth_rows, huber_delta)
    return Replayed(make_global_solve(intr, *settings, group,
                                      landmark_sharded),
                    ("global_ba", intr, settings, landmark_sharded, world),
                    name="global_ba",
                    cache=None if group is None else group.graphs)


# ---------------------------------------------------------------------------
def from_map_state(state, intr: Intrinsics, cfg, n_cams: int):
    """A global problem over the last ``n_cams`` keyframes of a
    ``MapState`` through the local window's construction
    (``ba/problem.build_problem``: its behind-camera and chi^2 gates and
    depth-dependent weights), the oldest real keyframe gauge-fixed and
    the window's depth-prior landmark as the scale anchor. Returns
    (data, slots, real); slots and real feed ``write_back``."""
    prob = build_problem(state, intr, dataclasses.replace(cfg, window=n_cams))
    cams = torch.arange(n_cams, device=prob.real.device)
    data = GlobalBAData(
        cam_q=prob.cam_q, cam_t=prob.cam_t, obs_uv=prob.obs_uv,
        mp_id=prob.mp_id, active=prob.active,
        w_z=torch.where(prob.active, prob.w_z, 0.0),
        z_meas=torch.where(prob.active, prob.z_meas, 0.0),
        w_d=torch.where(prob.active, prob.w_d, 0.0),
        cam_free=prob.real & (cams != prob.anchor_cam),
        mp_pos=state.mp_pos, anchor_mp=prob.anchor_mp)
    return data, prob.slots, prob.real


def write_back(state, data: GlobalBAData, slots, real):
    """The optimized poses and landmarks in a new ``MapState`` (padding
    rows dropped)."""
    return state._replace(
        kf_q=scatter_rows(state.kf_q, slots, real, data.cam_q),
        kf_t=scatter_rows(state.kf_t, slots, real, data.cam_t),
        mp_pos=data.mp_pos)


def make_synthetic_global_problem(rng, device, n_cams=8, n_pts=64,
                                  f_slots=64, noise=0.005):
    """A small synthetic problem built on the host with numpy, as the
    reference's (the same draws from ``rng``): (data on ``device``,
    intrinsics, {"pts": true landmarks})."""
    from scipy.spatial.transform import Rotation

    from kbslam_torch.geom.se3 import matrix_to_quat

    fx = fy = 100.0
    cx = cy = 50.0
    intr = Intrinsics.create(fx, fy, cx, cy)
    pts = rng.uniform([-1, -1, 2.0], [1, 1, 4.0],
                      size=(n_pts, 3)).astype(np.float32)
    rots, cam_t, obs_uv = [], [], []
    for i in range(n_cams):
        t = np.array([0.1 * i, 0.0, -0.02 * i], np.float32)
        R = Rotation.from_rotvec([0, 0.01 * i, 0]).as_matrix().astype(
            np.float32)
        pc = (pts - t) @ R
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        if i > 0:
            dR = Rotation.from_rotvec(rng.normal(scale=noise,
                                                 size=3)).as_matrix()
            R = (R @ dR).astype(np.float32)
            t = t + rng.normal(scale=noise, size=3).astype(np.float32)
        rots.append(R)
        cam_t.append(t)
        pad_uv = np.zeros((f_slots, 2), np.float32)
        pad_uv[:n_pts] = uv
        obs_uv.append(pad_uv)
    mp_id = np.full((n_cams, f_slots), -1, np.int32)
    mp_id[:, :n_pts] = np.arange(n_pts)
    mp_pos = np.zeros((n_pts + 16, 3), np.float32)
    mp_pos[:n_pts] = pts + rng.normal(scale=noise,
                                      size=pts.shape).astype(np.float32)
    mp_pos[0] = pts[0]  # the scale anchor stays at the truth
    cam_free = np.ones(n_cams, bool)
    cam_free[0] = False

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    zeros = np.zeros((n_cams, f_slots), np.float32)
    data = GlobalBAData(
        cam_q=matrix_to_quat(dev(np.stack(rots))), cam_t=dev(np.stack(cam_t)),
        obs_uv=dev(np.stack(obs_uv)), mp_id=dev(mp_id),
        active=dev(mp_id >= 0), w_z=dev(zeros + 1.0), z_meas=dev(zeros),
        w_d=dev(zeros), cam_free=dev(cam_free), mp_pos=dev(mp_pos),
        anchor_mp=torch.zeros((), dtype=torch.int32, device=device))
    return data, intr, dict(pts=pts)
