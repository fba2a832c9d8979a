"""Offline trajectory evaluation: ATE RMSE (Umeyama-aligned) and RPE.

The port's own copy of ``kbslam/eval/trajectory.py``, unchanged below
this docstring; tests/test_torch_copies.py holds the two equal.

The reference has no evaluation code at all (SURVEY §5.5); ATE parity
on TUM-style trajectories is this build's acceptance metric
(BASELINE.md), so the evaluator is part of the framework. Host-side
NumPy (float64) — this is offline analysis, not device compute.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid transform aligning src -> dst [N, 3].

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after rigid (or sim3) alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape and est.ndim == 2
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error over a frame delta.

    est_poses / gt_poses: [T, 4, 4] camera-to-world.
    Returns (trans_rmse [m], rot_rmse [rad]).
    """
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cosang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cosang))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )
