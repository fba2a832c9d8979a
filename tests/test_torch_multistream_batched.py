"""The port's stream-batched tracking program (config 4 as one program):
``pipeline.track_step_batched``, ``apply_pending_batched`` and the
batched modules under them, against their single-stream counterparts
and against the JAX reference's ``jax.vmap(track_step)``
(kbslam/parallel/multistream.py), on the tiny multistream scene of
tests/test_torch_parallel.py (tiny_config, 120x160, fx 130).

Bounds:
- every batched module (the describe twin, frame extraction, the
  matcher, RANSAC with injected sets, keyframe insertion and landmark
  creation, ``apply_pending``), stream by stream, equals its
  single-stream counterpart on that stream to the bit;
- the batched step over several frames and one K = 4 block of the
  batched scan, with JAX's per-stream minimal sets injected, against
  JAX's ``make_multistream_step``/``make_multistream_scan``: flags,
  match counts, keyframe ids and validity exact; at least 99% of the
  keyframes' valid keypoints within 1e-3 px, with equal descriptors on
  those (tests/test_torch_frontend.py's bound: one stream's frame 0 has
  2 of its keypoints 0.72 px apart, where a Harris parabola's vertex
  moves with float32 rounding, and JAX's vmapped and unbatched steps
  agree there); poses within 1 cm and 0.5 deg (the bound of
  tests/test_torch_pipeline.py and tests/test_torch_parallel.py);
- the NK = 3 keyframe bank: the batched step equals the single-stream
  step per stream to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import tiny_config
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.parallel.multistream import batched_init_state as j_binit
from kbslam.parallel.multistream import make_multistream_scan as j_scan
from kbslam.parallel.multistream import make_multistream_step as j_step
from kbslam_torch import convert
from kbslam_torch.frontend import orb
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.mapping.state import (create_map_points,
                                        create_map_points_batched,
                                        insert_keyframe,
                                        insert_keyframe_batched)
from kbslam_torch.matching.hamming import knn2_ratio_match
from kbslam_torch.ops.describe import (describe_keypoints,
                                       describe_keypoints_reference)
from kbslam_torch.parallel.multistream import (batched_init_state,
                                               make_multistream_scan,
                                               make_multistream_step,
                                               stream_state)
from kbslam_torch.pipeline import (apply_pending, apply_pending_batched,
                                   clone_state, extract_frame, track_step,
                                   track_step_batched)
from kbslam_torch.pnp.ransac import (hash_sampler, ransac_pnp,
                                     ransac_pnp_batched)
from kbslam_torch.slam import pose_T
from test_torch_pipeline import jax_sampler

torch.set_num_threads(1)
S, T = 3, 6
H, W = 120, 160


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_config(height=H, width=W)
    seqs = [render_sequence(num_frames=T, height=H, width=W, fx=130.0,
                            seed=s) for s in range(S)]
    rgb = np.stack([np.stack([s.rgb[t] for s in seqs]) for t in range(T)])
    dep = np.stack([np.stack([s.depth[t] for s in seqs]) for t in range(T)])
    return dict(cfg=cfg, rgb=torch.from_numpy(rgb), dep_raw=dep,
                dep=torch.from_numpy(dep.astype(np.int32)),
                intr=(130.0, 130.0, (W - 1) / 2, (H - 1) / 2))


def _counters(st):
    return st.frame_count * S + torch.arange(S, dtype=torch.int32)


def _leaves(st):
    return list(st.map) + list(st[1:])


def _same(a, b, what):
    assert a.shape == b.shape and torch.equal(a, b), what


@pytest.fixture(scope="module")
def tracked(scene):
    """The batched state after frames 0-1 (immediate insertion), and
    the streams' single-stream states, which must equal its rows."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    st = batched_init_state(cfg, S, "cpu")
    for t in range(2):
        st, _ = track_step_batched(st, scene["rgb"][t], scene["dep"][t], None,
                                   intr, cfg, hash_sampler(0, _counters(st)))
    singles = []
    for i in range(S):
        s1 = stream_state(batched_init_state(cfg, 1, "cpu"), 0)
        for t in range(2):
            s1, _ = track_step(s1, scene["rgb"][t, i], scene["dep"][t, i],
                               None, intr, cfg,
                               hash_sampler(0, s1.frame_count * S + i))
        for a, b in zip(_leaves(s1), _leaves(stream_state(st, i))):
            _same(a, b, ("state", i))
        singles.append(s1)
    return st, singles


def test_batched_describe_twin_equals_per_stream():
    """[S, L, H, W] through the wrapper (the twin on the CPU) against
    each stream's own call, at an odd keypoint count."""
    g = np.random.default_rng(0)
    L, h, w, n = 3, 72, 96, 77
    stacked = torch.from_numpy(g.random((S, L, h, w), np.float32) * 255)
    level = torch.from_numpy(g.integers(0, L, (S, n)).astype(np.int32))
    y0 = torch.from_numpy(g.integers(-5, h, (S, n)).astype(np.int32))
    x0 = torch.from_numpy(g.integers(-5, w, (S, n)).astype(np.int32))
    angle, bits = describe_keypoints(stacked, level, y0, x0)
    assert angle.shape == (S, n) and bits.shape == (S, n, 256)
    for i in range(S):
        a1, b1 = describe_keypoints_reference(stacked[i], level[i], y0[i],
                                              x0[i])
        _same(a1, angle[i], ("angle", i))
        _same(b1, bits[i], ("bits", i))


@pytest.mark.parametrize("masked", [False, True])
def test_batched_extract_equals_per_stream(scene, masked):
    """ORB, keypoint depth, the rim gate and (with ``masked``) a static
    mask, on three frames at once."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, depth_edge_max_spread=0.15, depth_edge_rel_per_m2=0.02))
    rgb, dep = scene["rgb"][2], scene["dep"][2]
    mask = None
    if masked:
        mask = torch.ones((S, H, W), dtype=torch.uint8)
        mask[:, 30:70, 40:100] = 0
    feats, depth_kp = extract_frame(rgb, dep, mask, intr, cfg, batched=True)
    assert feats.xy.shape == (S, cfg.orb.max_features, 2)
    for i in range(S):
        f1, d1 = extract_frame(rgb[i], dep[i], None if mask is None
                               else mask[i], intr, cfg)
        for name, a, b in zip(f1._fields, f1, feats):
            _same(a, b[i], (name, i))
        _same(d1, depth_kp[i], ("depth", i))
    assert int(feats.count().min()) > 0


@pytest.mark.parametrize("cross_check", [False, True])
def test_batched_match_equals_per_stream(scene, tracked, cross_check):
    cfg = scene["cfg"]
    st, _ = tracked
    feats, _ = extract_frame(scene["rgb"][3], scene["dep"][3], None,
                             TIntr.create(*scene["intr"]), cfg, batched=True)
    slot = st.map.last_slot()
    q_desc = torch.stack([st.map.kf_desc[i, slot[i]] for i in range(S)])
    q_valid = torch.stack([st.map.kf_kp_valid[i, slot[i]] for i in range(S)])
    m = knn2_ratio_match(q_desc, q_valid, feats.desc, feats.valid,
                         cfg.matcher.ratio, cross_check=cross_check)
    for i in range(S):
        m1 = knn2_ratio_match(q_desc[i], q_valid[i], feats.desc[i],
                              feats.valid[i], cfg.matcher.ratio,
                              cross_check=cross_check)
        for name, a, b in zip(m1._fields, m1, m):
            _same(a, b[i], (name, i))
    assert int(m.is_match.sum(-1).min()) > 0


def _stacked(samplers):
    """A batched sampler from one single-stream sampler per stream."""
    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        sets = [s(v, p, k_dlt, k_kabsch, set_size, packed)
                for s, v, p in zip(samplers, valid, pool)]
        return (torch.stack([d for d, _ in sets]),
                torch.stack([k for _, k in sets]))
    return sample


def test_batched_ransac_equals_per_stream():
    """S problems with outliers and some missing depth, JAX's minimal
    sets injected stream by stream."""
    g = np.random.default_rng(3)
    intr = TIntr.create(130.0, 130.0, 79.5, 59.5)
    cfg = tiny_config(height=H, width=W).pnp
    n = 96
    pts, uv, valid, pts_obs, obs_ok = [], [], [], [], []
    for i in range(S):
        X = np.c_[g.uniform(-1, 1, (n, 2)), g.uniform(2, 4, n)]
        t = np.array([0.05 * i, -0.02, 0.03])
        Xc = X + t
        p = np.c_[130 * Xc[:, 0] / Xc[:, 2] + 79.5,
                  130 * Xc[:, 1] / Xc[:, 2] + 59.5]
        p[: 10 + 5 * i] += g.uniform(-30, 30, (10 + 5 * i, 2))
        v = np.arange(n) < n - 7 * i
        pts.append(X)
        uv.append(p)
        valid.append(v)
        pts_obs.append(Xc)
        obs_ok.append(g.random(n) > 0.2)
    args = [torch.from_numpy(np.stack(a).astype(np.float32))
            for a in (pts, uv)]
    vb = torch.from_numpy(np.stack(valid))
    ob = torch.from_numpy(np.stack(pts_obs).astype(np.float32))
    okb = torch.from_numpy(np.stack(obs_ok))
    keys = [jax.random.PRNGKey(10 + i) for i in range(S)]
    res = ransac_pnp_batched(*args, vb, intr, cfg,
                             _stacked([jax_sampler(k) for k in keys]),
                             points3d_obs=ob, obs_valid=okb)
    assert bool(res.success.all())
    for i in range(S):
        r1 = ransac_pnp(args[0][i], args[1][i], vb[i], intr, cfg,
                        jax_sampler(keys[i]), points3d_obs=ob[i],
                        obs_valid=okb[i], valid_packed=True)
        for name, a, b in (("success", r1.success, res.success),
                           ("q", r1.T_cw.q, res.T_cw.q),
                           ("t", r1.T_cw.t, res.T_cw.t),
                           ("ratio", r1.inlier_ratio, res.inlier_ratio),
                           ("inliers", r1.inliers, res.inliers),
                           ("count", r1.num_inliers, res.num_inliers)):
            _same(a, b[i], (name, i))


def test_batched_insertion_and_apply_pending_equal_per_stream(scene,
                                                              tracked):
    """Frame 3 inserted into every stream (one stream masked off), as
    an immediate insertion with landmark creation and as a deferred one
    applied later."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    st, singles = tracked
    rgb, dep = scene["rgb"][3], scene["dep"][3]
    _, _, pend = track_step_batched(clone_state(st), rgb, dep, None, intr,
                                    cfg, hash_sampler(0, _counters(st)),
                                    defer_insert=True)
    do = torch.tensor([True, False, True])
    pend = pend._replace(do=do)
    feats, depth_kp = extract_frame(rgb, dep, None, intr, cfg, batched=True)
    slot = st.map.last_slot()
    q_desc = torch.stack([st.map.kf_desc[i, slot[i]] for i in range(S)])
    q_valid = torch.stack([st.map.kf_kp_valid[i, slot[i]] for i in range(S)])
    match = knn2_ratio_match(q_desc, q_valid, feats.desc, feats.valid,
                             cfg.matcher.ratio)
    from kbslam_torch.geom.se3 import SE3
    pose = SE3(pend.pose_q, pend.pose_t)
    m = insert_keyframe_batched(clone_state(st).map, feats, depth_kp, pose,
                                do=do)
    m = create_map_points_batched(m, match, intr.fx, intr.fy, intr.cx,
                                  intr.cy, do=do)
    applied = apply_pending_batched(clone_state(st).map, pend, intr)
    for i in range(S):
        fi = orb.Features(*(f[i] for f in feats))
        mi = type(match)(*(f[i] for f in match))
        m1 = insert_keyframe(clone_state(singles[i]).map, fi, depth_kp[i],
                             SE3(pend.pose_q[i], pend.pose_t[i]), do=do[i])
        m1 = create_map_points(m1, mi, intr.fx, intr.fy, intr.cx, intr.cy,
                               do=do[i])
        p1 = type(pend)(*(f[i] for f in pend))
        a1 = apply_pending(clone_state(singles[i]).map, p1, intr)
        for name, a, b, c in zip(m1._fields, m1, m, a1):
            _same(a, b[i], ("immediate", name, i))
        for name, a, b in zip(a1._fields, a1, applied):
            _same(a, b[i], ("applied", name, i))
    assert int(m.num_kf[1]) == int(st.map.num_kf[1])
    assert bool((m.num_mp[[0, 2]] > st.map.num_mp[[0, 2]]).all())


def _pose_gap(qa, ta, qb, tb):
    Ta, Tb = pose_T(qa, ta), pose_T(qb, tb)
    c = np.clip((np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1) / 2, -1, 1)
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), np.degrees(np.arccos(c))


def _jax_keys(counters):
    return [jax.random.fold_in(jax.random.PRNGKey(0), int(c))
            for c in counters]


def _jax_sets(counters):
    """The batched sampler that injects, for stream i, the sets JAX's
    multistream scan draws from fold_in(PRNGKey(0), counter[i])."""
    return _stacked([jax_sampler(k) for k in _jax_keys(counters)])


def _same_keyframes(t_map, j_map, what):
    """Keyframe ids, counts and validity exact; of the valid keypoints at
    least 99% within 1e-3 px of JAX's, with equal descriptors on those
    (the bound of tests/test_torch_frontend.py: float32 rounding moves a
    Harris parabola's vertex now and then)."""
    for name in ("num_kf", "kf_kp_valid", "kf_id"):
        np.testing.assert_array_equal(getattr(t_map, name).numpy(),
                                      np.asarray(getattr(j_map, name)),
                                      err_msg=f"{what} {name}")
    valid = t_map.kf_kp_valid.numpy()
    gap = np.abs(t_map.kf_kp_xy.numpy() - np.asarray(j_map.kf_kp_xy))
    close = valid & (gap.max(-1) < 1e-3)
    assert close.sum() >= 0.99 * valid.sum(), (what, close.sum(), valid.sum())
    np.testing.assert_array_equal(t_map.kf_desc.numpy()[close],
                                  np.asarray(j_map.kf_desc)[close],
                                  err_msg=f"{what} kf_desc")


def _same_as_jax(t_out, j_out, t_map, j_map, what):
    for name in ("success", "added_kf", "num_matches", "num_features"):
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      np.asarray(getattr(j_out, name)),
                                      err_msg=f"{what} {name}")
    _same_keyframes(t_map, j_map, what)
    for i in range(t_out.pose_q.shape[0]):
        dt, dr = _pose_gap(t_out.pose_q[i].numpy(), t_out.pose_t[i].numpy(),
                           np.asarray(j_out.pose_q[i]),
                           np.asarray(j_out.pose_t[i]))
        assert dt < 0.01 and dr < 0.5, (what, i, dt, dr)


def test_batched_step_and_scan_match_jax_multistream(scene):
    """Frames 0-1 through the batched step (``make_multistream_step``)
    against JAX's vmapped step, then one K = 4 block of the batched scan (frames 2-5, a keyframe
    flagged on frame 4 and applied at the block's end) against JAX's
    scan from JAX's state, with JAX's per-stream sets injected."""
    cfg, (fx, fy, cx, cy) = scene["cfg"], scene["intr"]
    # a keyframe flagged on frame 4, inside the scan's block
    cfg = dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, min_frame_gap=4, min_inlier_ratio=1.1))
    jintr, tintr = JIntr.create(fx, fy, cx, cy), TIntr.create(fx, fy, cx, cy)
    rgb, dep, dep_raw = scene["rgb"], scene["dep"], scene["dep_raw"]
    jstep = j_step(cfg, jintr, donate=False)
    tstep = make_multistream_step(cfg, tintr, S, sampler_for=lambda c: (
        _jax_sets(c.tolist())))
    jst, tst = j_binit(cfg, S), batched_init_state(cfg, S, "cpu")
    for t in range(2):
        counters = [t * S + i for i in range(S)]
        jst, jout = jstep(jst, jnp.asarray(rgb[t].numpy()),
                          jnp.asarray(dep_raw[t]),
                          jnp.stack(_jax_keys(counters)))
        tst, tout = tstep(tst, rgb[t], dep[t])
        jst, jout = jax.device_get(jst), jax.device_get(jout)
        _same_as_jax(tout, jout, tst.map, jst.map, f"step frame {t}")
    assert bool(tout.success.all())

    # the scan, both from JAX's state after frame 1
    K = 4
    start = convert.to_torch(jst, "cpu")
    scan = make_multistream_scan(cfg, tintr, S, apply_every=K,
                                 sampler_for=lambda c: _jax_sets(c.tolist()))
    t_end, t_ninl = scan(start, rgb[2:2 + K], dep[2:2 + K])
    j_end, j_ninl = j_scan(cfg, jintr, apply_every=K, donate=False)(
        jst, jnp.asarray(rgb[2:2 + K].numpy()), jnp.asarray(dep_raw[2:2 + K]))
    j_end = jax.device_get(j_end)
    assert t_ninl.shape == (K, S)
    ok = (t_ninl > 0).numpy() == (np.asarray(j_ninl) > 0)
    assert ok.all(), (t_ninl, j_ninl)
    _same_keyframes(t_end.map, j_end.map, "scan")
    np.testing.assert_array_equal(t_end.frame_count.numpy(),
                                  np.asarray(j_end.frame_count))
    assert (t_end.map.num_kf.numpy() == np.asarray(jst.map.num_kf) + 1).all()
    for i in range(S):
        dt, dr = _pose_gap(t_end.pose_q[i].numpy(), t_end.pose_t[i].numpy(),
                           np.asarray(j_end.pose_q[i]),
                           np.asarray(j_end.pose_t[i]))
        assert dt < 0.01 and dr < 0.5, ("scan", i, dt, dr)


def test_batched_bank_equals_per_stream(scene):
    """``track_keyframes`` = 3: the batched step's bank of each stream's
    last three keyframes, per stream equal to the single-stream step, to
    the bit, with a keyframe on every frame (min_frame_gap 0)."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    cfg = dataclasses.replace(cfg, track_keyframes=3, policy=(
        dataclasses.replace(cfg.policy, min_frame_gap=0,
                            min_inlier_ratio=1.1)))
    st = batched_init_state(cfg, S, "cpu")
    singles = [stream_state(batched_init_state(cfg, 1, "cpu"), 0)
               for _ in range(S)]
    for t in range(5):
        st, out = track_step_batched(st, scene["rgb"][t], scene["dep"][t],
                                     None, intr, cfg,
                                     hash_sampler(0, _counters(st)))
        for i in range(S):
            singles[i], o1 = track_step(
                singles[i], scene["rgb"][t, i], scene["dep"][t, i], None,
                intr, cfg, hash_sampler(0, singles[i].frame_count * S + i))
            for name, a, b in zip(o1._fields, o1, out):
                _same(a, b[i], (t, name, i))
    assert (st.map.num_kf >= 4).all(), st.map.num_kf
    for i in range(S):
        for a, b in zip(_leaves(singles[i]), _leaves(stream_state(st, i))):
            _same(a, b, ("bank state", i))
