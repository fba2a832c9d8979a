"""The other two cases of tests/test_ba_in_loop.py on the port's SLAM.

- The rotation-dominant low-texture sweep (:74-93): 120 frames of
  240x320 spheres, 180 texture rectangles, 2 mm depth noise and 10%
  depth dropout on ``rotation_trajectory``, ``track_keyframes=3``, BA
  off and on, with that test's gates. The port is given the minimal sets
  the JAX shell draws (``test_torch_slam._jax_keyed_sampler``).
- The NK=1 "BA does not hurt" case (:96-111), with that test's gates,
  on the port's own draws.

Why the rotation case is pinned on the reference's sets: the sweep's
online ATE is decided by which RANSAC basin a few frames fall into, and
float32 rounding picks the basin. At frame 1, with equal inputs and
equal sets, both packages pick the same DLT hypothesis, but its minimal
solve is near-degenerate: 1e-7 relative nudges of its six points move
the reference's own polished translation by up to 25 cm, more than the
two packages' results differ. Over RANSAC seeds 0-4 the BA-off ATE moves
over tens of millimetres, far more than the gate's 5% + 1 mm, and the
relative gate holds on some seeds and misses on others, with the port's
own draws as with the reference's (ROADMAP.md §3). With the
reference's sets every gate holds on the port's own numbers.

Run as a script (``python tests/test_torch_ba_in_loop_more.py`` with the
repository and ``tests/`` on ``PYTHONPATH``), it prints the sweep's
gates with the port's own draws and the reference's over RANSAC seeds
0-4, the frame where the two shells part with the reference's sets, and
that frame's minimal solve under the nudges.
"""
import numpy as np
import torch

from kbslam.eval.trajectory import ate_rmse
from kbslam.io.synthetic import render_sequence, rotation_trajectory
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.pipeline import make_track_step
from kbslam_torch.slam import SLAM
from test_ba_in_loop import _cfg
from test_torch_slam import _jax_keyed_sampler

torch.set_num_threads(1)

N_ROT = 120


def _rotation_scene():
    return render_sequence(num_frames=N_ROT, height=240, width=320, seed=0,
                           poses=rotation_trajectory(N_ROT), scene="spheres",
                           depth_noise_mm=2.0, depth_dropout=0.10,
                           texture_rects=180)


def _track(seq, mode, cfg, jax_sets=False, seed=0, shell=SLAM):
    """test_ba_in_loop._track on ``shell`` (the port's SLAM on the CPU
    unless given the reference's), optionally with the reference's
    minimal sets."""
    kw = {} if shell is not SLAM else dict(device="cpu")
    s = shell(cfg, seq.K, ba_mode=mode, use_mask=False, seed=seed, **kw)
    if jax_sets:
        s._step = make_track_step(cfg, TIntr.from_matrix(seq.K),
                                  use_mask=False,
                                  sampler_for_frame=_jax_keyed_sampler)
    for i in range(len(seq.rgb)):
        s.process(seq.rgb[i], seq.depth[i])
    est = np.stack(s.frame_poses)
    n_succ = sum(d["success"] for d in s.diagnostics)
    return ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3]), n_succ, s


def _rotation_gates(seq, jax_sets, seed=0, shell=SLAM):
    """(ATE off, on, refined, frames tracked with BA on, solves) of the
    sweep, and the names of test_ba_in_loop.py:87-91's gates it fails."""
    cfg = _cfg(max_kf=32, max_mp=16384)
    ate_off, _, _ = _track(seq, "disabled", cfg, jax_sets, seed, shell)
    ate_on, succ_on, s_on = _track(seq, "on_keyframe", cfg, jax_sets, seed,
                                   shell)
    refined = s_on.refined_trajectory()
    ate_ref = ate_rmse(refined[:, :3, 3], seq.poses[:, :3, 3])
    checks = {"succ_on >= N - 6": succ_on >= N_ROT - 6,
              "solves >= 6": len(s_on.ba_stats) >= 6,
              "on <= 1.05 off + 1 mm": ate_on <= 1.05 * ate_off + 1e-3,
              "refined <= on + 1 mm": ate_ref <= ate_on + 1e-3,
              "refined < 0.06": ate_ref < 0.06}
    return ((ate_off, ate_on, ate_ref, succ_on, len(s_on.ba_stats)),
            [k for k, ok in checks.items() if not ok])


def test_ba_in_loop_rotation_dominant_low_texture():
    numbers, failed = _rotation_gates(_rotation_scene(), jax_sets=True)
    assert not failed, (failed, numbers)


def test_ba_not_hurting_at_reference_parity():
    seq = render_sequence(num_frames=40, height=240, width=320,
                          scene="spheres", depth_noise_mm=2.0,
                          depth_dropout=0.02, seed=0)
    cfg = _cfg().replace(track_keyframes=1)
    ate_off, _, _ = _track(seq, "disabled", cfg)
    ate_on, succ_on, s_on = _track(seq, "on_keyframe", cfg)
    assert succ_on >= 36, succ_on
    assert len(s_on.ba_stats) >= 2
    assert ate_on <= 1.05 * ate_off + 1e-3, (ate_on, ate_off)


def _frame1_minimal_solve(seq):
    """The frame-1 RANSAC of the sweep with the reference's sets, on the
    port's inputs in both packages: (the hypothesis each picks, its
    polished translation in each, the reference's polished translation
    of that set under five 1e-7 relative nudges of its points)."""
    import jax
    import jax.numpy as jnp

    import kbslam_torch.pipeline as tp
    from kbslam.geom.camera import Intrinsics as JIntr
    from kbslam.geom.camera import project as jproject
    from kbslam.geom.se3 import SE3 as JSE3
    from kbslam.geom.se3 import matrix_to_quat as jm2q
    from kbslam.pnp.dlt import normalized_rays as jrays
    from kbslam.pnp.dlt import solve_dlt as jdlt
    from kbslam.pnp.kabsch import solve_kabsch as jkab
    from kbslam.pnp.refine import refine_pose as jref
    from kbslam.pnp.ransac import _sample_valid_indices
    from kbslam_torch.geom.camera import project as tproject
    from kbslam_torch.geom.se3 import SE3 as TSE3
    from kbslam_torch.geom.se3 import matrix_to_quat as tm2q
    from kbslam_torch.pnp.dlt import normalized_rays as trays
    from kbslam_torch.pnp.dlt import solve_dlt as tdlt
    from kbslam_torch.pnp.kabsch import solve_kabsch as tkab
    from kbslam_torch.pnp.refine import refine_pose as tref

    cfg = _cfg(max_kf=32, max_mp=16384)
    pc = cfg.pnp
    seen, real = [], tp.ransac_pnp

    def capture(*a, **k):
        seen.append((a, k))
        return real(*a, **k)
    tp.ransac_pnp = capture
    try:
        _track(seq._replace(rgb=seq.rgb[:2], depth=seq.depth[:2],
                            poses=seq.poses[:2]), "disabled",
               cfg, True)
    finally:
        tp.ransac_pnp = real
    (p3, p2, valid, _, _, _), kw = seen[-1]
    p3o, ov = kw["points3d_obs"], kw["obs_valid"]
    K, S = pc.num_hypotheses, pc.sample_size
    Kd = max(int(K * pc.dlt_fraction), 1)
    ji, ti = JIntr.from_matrix(seq.K), TIntr.from_matrix(seq.K)
    thr2 = pc.reproj_threshold ** 2
    key_a, key_b = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), 1))
    both = (valid & ov) if bool((valid & ov).any()) else valid
    idx = torch.from_numpy(np.array(jnp.concatenate([
        _sample_valid_indices(key_a, jnp.asarray(valid.numpy()), Kd, S,
                              packed=True),
        _sample_valid_indices(key_b, jnp.asarray(both.numpy()), K - Kd,
                              S)]))).long()
    rows = torch.cat([p3, p2, p3o], 1)[idx.reshape(-1)].reshape(K, S, -1)

    def jax_polished(rows, p3, p2, valid):
        pts, uv = rows[..., :3], rows[..., 3:5]
        R_d, t_d = jdlt(pts[:Kd], jrays(ji, uv[:Kd]))
        R_k, t_k = jkab(pts[Kd:], rows[Kd:, :, 5:8])
        T = JSE3(jm2q(jnp.concatenate([R_d, R_k])),
                 jnp.concatenate([t_d, t_k])).normalize()
        ones = jnp.ones(S, jnp.float32)
        Th = jax.vmap(lambda q, t, p, u: jref(JSE3(q, t), p, u, ones, ji,
                                              iters=pc.polish_iters))(
            T.q, T.t, pts, uv)
        pcam = (jnp.einsum("kij,nj->kni", Th.rotation_matrix(), p3)
                + Th.t[:, None, :])
        uvp, z = jproject(ji, pcam)
        inl = (jnp.sum((uvp - p2[None]) ** 2, -1) < thr2) & (z > 0) & valid
        return Th.t, jnp.sum(inl, 1)

    jfn = jax.jit(jax_polished)
    j_t, j_counts = (np.asarray(x) for x in jfn(
        jnp.asarray(rows.numpy()), jnp.asarray(p3.numpy()),
        jnp.asarray(p2.numpy()), jnp.asarray(valid.numpy())))
    pts, uv = rows[..., :3], rows[..., 3:5]
    R, t = tdlt(pts[:Kd], trays(ti, uv[:Kd]))
    R_k, t_k = tkab(pts[Kd:], rows[Kd:, :, 5:8])
    T = TSE3(tm2q(torch.cat([R, R_k])), torch.cat([t, t_k])).normalize()
    Th = tref(T, pts, uv, torch.ones(S), ti, iters=pc.polish_iters)
    pcam = (torch.einsum("kij,nj->kni", Th.rotation_matrix(), p3)
            + Th.t[:, None, :])
    uvp, z = tproject(ti, pcam)
    t_counts = (((uvp - p2[None]) ** 2).sum(-1) < thr2) & (z > 0) & valid
    h_j, h_t = int(np.argmax(j_counts)), int(torch.argmax(t_counts.sum(1)))
    rng = np.random.default_rng(0)
    nudged = []
    for _ in range(5):
        r = rows.numpy().copy()
        r[h_j, :, :3] *= 1 + rng.standard_normal((S, 3)) * 1e-7
        nudged.append(np.asarray(jfn(jnp.asarray(r), jnp.asarray(p3.numpy()),
                                     jnp.asarray(p2.numpy()),
                                     jnp.asarray(valid.numpy()))[0])[h_j])
    return h_j, h_t, j_t[h_j], Th.t[h_t].numpy(), np.stack(nudged)


def test_rotation_frame1_minimal_solve_is_decided_by_rounding():
    """The finding behind the pin: at the sweep's frame 1, with equal
    inputs and equal sets, both packages pick the same hypothesis, whose
    polished pose a 1e-7 relative nudge of its points moves by more than
    the two packages' difference."""
    h_j, h_t, t_j, t_t, nudged = _frame1_minimal_solve(_rotation_scene())
    assert h_j == h_t
    spread = np.linalg.norm(nudged - t_j, axis=1).max()
    assert spread > 0.01, spread
    assert spread > np.linalg.norm(t_t - t_j), (spread, t_t, t_j)


if __name__ == "__main__":
    from kbslam.slam import SLAM as JSLAM

    seq = _rotation_scene()
    for rs in range(5):
        for name, shell in (("port", SLAM), ("JAX", JSLAM)):
            (off, on, ref, succ, solves), failed = _rotation_gates(
                seq, False, rs, shell)
            print(f"rotation sweep, {name}'s own draws, RANSAC seed {rs}: "
                  f"ATE BA off {off * 1e3:.2f} mm, on {on * 1e3:.2f} mm, "
                  f"refined {ref * 1e3:.2f} mm, {succ}/{N_ROT} tracked, "
                  f"{solves} solves; gates failed: {failed or 'none'}",
                  flush=True)
    (off, on, ref, succ, solves), failed = _rotation_gates(seq, True)
    print(f"rotation sweep, the port with JAX's sets: ATE BA off "
          f"{off * 1e3:.2f} mm, on {on * 1e3:.2f} mm, refined "
          f"{ref * 1e3:.2f} mm; gates failed: {failed or 'none'}")
    from test_torch_slam import _run

    j, t = _run(seq._replace(rgb=seq.rgb[:30], depth=seq.depth[:30],
                             poses=seq.poses[:30]),
                _cfg(32, 16384), "disabled")
    gaps = [np.linalg.norm(a[:3, 3] - b[:3, 3])
            for a, b in zip(j.frame_poses, t.frame_poses)]
    print("frames 0-29 with JAX's sets, BA off, port vs JAX shell (m):",
          [f"{g:.1e}" for g in gaps])
    h_j, h_t, t_j, t_t, nudged = _frame1_minimal_solve(seq)
    print(f"frame 1: hypothesis JAX {h_j}, port {h_t}; polished t JAX "
          f"{t_j}, port {t_t}; JAX under 1e-7 nudges {nudged.tolist()}")
