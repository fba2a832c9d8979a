"""The port's multistream tracking (kbslam_torch/parallel/multistream.py)
and deferred keyframe insertion (``track_step(defer_insert=True)``,
``apply_pending``) against the JAX reference, on the tiny multistream
scene of tests/test_parallel.py (tiny_config, 120x160, fx 130).

Bounds:
- deferred insertion, one frame from JAX's map with JAX's minimal sets
  injected: the ``PendingInsert`` flags, keypoint validity, descriptors
  and fusion matches equal JAX's; keypoints within 1e-3 px, their depth
  within 1e-4 m, the pose within 1 cm and 0.5 deg (the bound of
  tests/test_torch_pipeline.py). After ``apply_pending`` every integer
  and mask field of the map equals JAX's, and the floats agree to the
  same bounds (landmarks within 1 cm). In the port, deferring and then
  applying stores exactly what the immediate insertion stores, to the
  bit;
- independence: each stream of the port's multistream step equals a
  single-stream run of the same stream with the same draws, to the bit;
- the deferred scan: tests/test_parallel.py:95-156's gates on the
  port's own numbers.

``test_parallel.py::test_branchless_insert_matches_cond_path`` has no
case here: the port's insertion is always the masked one, so there is no
second insertion path to hold it against. The streams sharded over a
process group (``shard_streams``) are held to this file's unsharded step
in tests/test_torch_distributed.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import tiny_config
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.pipeline import apply_pending as j_apply
from kbslam.pipeline import init_state as j_init
from kbslam.pipeline import track_step as j_track
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.parallel.multistream import (batched_init_state,
                                               make_multistream_scan,
                                               make_multistream_step,
                                               stream_state)
from kbslam_torch.pipeline import apply_pending, init_state, track_step
from kbslam_torch.pnp.ransac import hash_sampler
from kbslam_torch.slam import pose_T
from kbslam_torch.streaming import clone_state
from test_torch_pipeline import jax_sampler

torch.set_num_threads(1)
S, T = 2, 24
H, W = 120, 160


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_config(height=H, width=W)
    seqs = [render_sequence(num_frames=T, height=H, width=W, fx=130.0,
                            seed=s) for s in range(S)]
    rgb = np.stack([np.stack([s.rgb[t] for s in seqs]) for t in range(T)])
    dep = np.stack([np.stack([s.depth[t] for s in seqs]) for t in range(T)])
    return dict(cfg=cfg, rgb=rgb, dep=dep,
                intr=(130.0, 130.0, (W - 1) / 2, (H - 1) / 2))


def _pose_gap(qa, ta, qb, tb):
    Ta, Tb = pose_T(qa, ta), pose_T(qb, tb)
    c = np.clip((np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1) / 2, -1, 1)
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), np.degrees(np.arccos(c))


_EXACT_MAP = ("kf_kp_valid", "kf_desc", "kf_mp", "kf_id", "num_kf",
              "mp_valid", "num_mp")


def _same_map(t_map, j_map):
    for name in _EXACT_MAP:
        np.testing.assert_array_equal(getattr(t_map, name).numpy(),
                                      np.asarray(getattr(j_map, name)),
                                      err_msg=name)
    for name, tol in (("kf_q", 1e-4), ("kf_t", 1e-2), ("kf_kp_xy", 1e-3),
                      ("kf_kp_depth", 1e-4), ("mp_pos", 1e-2)):
        np.testing.assert_allclose(getattr(t_map, name).numpy(),
                                   np.asarray(getattr(j_map, name)),
                                   atol=tol, err_msg=name)


def test_deferred_insertion_matches_reference(scene):
    """Frame 0 (an empty map: the fresh insertion) and the first later
    keyframe of stream 0, each from JAX's state before it."""
    cfg, (fx, fy, cx, cy) = scene["cfg"], scene["intr"]
    jintr, tintr = JIntr.create(fx, fy, cx, cy), TIntr.create(fx, fy, cx, cy)
    rgb, dep = scene["rgb"][:, 0], scene["dep"][:, 0]
    jstep = jax.jit(lambda s, r, d, k: j_track(s, r, d, None, k, jintr, cfg))
    jdefer = jax.jit(lambda s, r, d, k: j_track(s, r, d, None, k, jintr,
                                                cfg, defer_insert=True))
    japply = jax.jit(lambda m, p: j_apply(m, p, jintr, cfg))

    # JAX's state before frame 0 and before its first later keyframe
    state, before = j_init(cfg), {0: j_init(cfg)}
    for f in range(T):
        nxt, out = jstep(state, jnp.asarray(rgb[f]), jnp.asarray(dep[f]),
                         jax.random.PRNGKey(f))
        if f > 0 and bool(out.added_kf):
            before[f] = state
            break
        state = nxt
    assert len(before) == 2, "no keyframe after frame 0"

    for f, jstate in before.items():
        key = jax.random.PRNGKey(f)
        js, jout, jp = jdefer(jstate, jnp.asarray(rgb[f]),
                              jnp.asarray(dep[f]), key)
        jp = jax.device_get(jp)
        args = (torch.from_numpy(rgb[f]),
                torch.from_numpy(dep[f].astype(np.int32)))
        tstate = convert.to_torch(jax.device_get(jstate), "cpu")
        ts, tout, tp = track_step(clone_state(tstate), *args, None, tintr,
                                  cfg, jax_sampler(key), defer_insert=True)
        assert bool(tp.do) and bool(jp.do)
        assert bool(tp.fresh) == bool(jp.fresh) == (f == 0)
        for name in ("kp_valid", "kp_desc", "fuse_idx", "fuse_ok"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          err_msg=name)
        np.testing.assert_allclose(tp.kp_xy.numpy(), jp.kp_xy, atol=1e-3)
        np.testing.assert_allclose(tp.kp_depth.numpy(), jp.kp_depth,
                                   atol=1e-4)
        dt, dr = _pose_gap(tp.pose_q.numpy(), tp.pose_t.numpy(), jp.pose_q,
                           jp.pose_t)
        assert dt < 0.01 and dr < 0.5, (f, dt, dr)
        # the map is untouched until the pending insertion is applied
        assert int(ts.map.num_kf) == int(jstate.map.num_kf)
        assert int(tout.anchor_id) == int(jout.anchor_id)

        t_map = apply_pending(ts.map, tp, tintr)
        _same_map(t_map, jax.device_get(japply(js.map, jp)))

        # deferring then applying stores what the immediate step stores
        imm, _ = track_step(clone_state(tstate), *args, None, tintr, cfg,
                            jax_sampler(key))
        for name, a, b in zip(t_map._fields, t_map, imm.map):
            assert torch.equal(a, b), name


def _tensors(scene, t0, t1):
    return (torch.from_numpy(scene["rgb"][t0:t1]),
            torch.from_numpy(scene["dep"][t0:t1].astype(np.int32)))


def test_multistream_streams_are_independent(scene):
    """S = 2, T = 8: every stream of the multistream step equals the
    single-stream step of that stream with the same draws
    (hash_sampler(0, frame * S + i)), outputs and state to the bit."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    rgb, dep = _tensors(scene, 0, 8)
    step = make_multistream_step(cfg, intr, S)
    state, outs = batched_init_state(cfg, S, "cpu"), []
    for t in range(8):
        state, out = step(state, rgb[t], dep[t])
        outs.append(out)
    # the gates of tests/test_parallel.py:15-47
    assert tuple(state.map.num_kf.shape) == (S,)
    assert (state.map.num_kf >= 1).all() and outs[0].added_kf.all()
    assert len(set(int(x) for x in outs[-1].num_matches)) > 1

    for i in range(S):
        st = init_state(cfg, "cpu")
        for t in range(8):
            st, o = track_step(st, rgb[t, i], dep[t, i], None, intr, cfg,
                               hash_sampler(0, st.frame_count * S + i))
            for name, a, b in zip(o._fields, o, outs[t]):
                assert torch.equal(a, b[i]), (i, t, name)
        mine = stream_state(state, i)
        for a, b in zip(list(st.map) + list(st[1:]),
                        list(mine.map) + list(mine[1:])):
            assert torch.equal(a, b)


def test_deferred_scan_tracks_like_immediate(scene):
    """tests/test_parallel.py:95-156 on the port: S = 2, T = 24,
    apply_every = 4, from a warm start; keyframe counts within 1 of the
    immediate path's, landmarks created, the tracked share and the mean
    inlier count in the immediate path's regime."""
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    rgb, dep = _tensors(scene, 0, T)
    step = make_multistream_step(cfg, intr, S)
    warm, _ = step(batched_init_state(cfg, S, "cpu"), rgb[0], dep[0])
    n = T - 4          # a multiple of apply_every after the warm frame
    rgb, dep = rgb[1:n + 1], dep[1:n + 1]

    scan = make_multistream_scan(cfg, intr, S, apply_every=4)
    st_d, ninl_d = scan(clone_state(warm), rgb, dep)
    st_i, ninl_i = clone_state(warm), []
    for t in range(n):
        st_i, out = step(st_i, rgb[t], dep[t])
        ninl_i.append(out.num_inliers)
    ninl_i, ninl_d = torch.stack(ninl_i).numpy(), ninl_d.numpy()
    assert ninl_d.shape == (n, S)

    kfs_d, kfs_i = st_d.map.num_kf.numpy(), st_i.map.num_kf.numpy()
    assert (kfs_d >= 2).all(), kfs_d
    assert (np.abs(kfs_d - kfs_i) <= 1).all(), (kfs_d, kfs_i)
    assert (st_d.map.num_mp > 0).all()
    ok_d, ok_i = (ninl_d[2:] > 0).mean(), (ninl_i[2:] > 0).mean()
    assert ok_d >= ok_i - 0.15, (ok_d, ok_i)
    assert ninl_d[2:].mean() >= 0.7 * ninl_i[2:].mean()


def test_deferred_scan_checks_its_block(scene):
    cfg, intr = scene["cfg"], TIntr.create(*scene["intr"])
    with pytest.raises(ValueError, match="min_frame_gap"):
        make_multistream_scan(cfg, intr, S,
                              apply_every=cfg.policy.min_frame_gap + 1)
    scan = make_multistream_scan(cfg, intr, S, apply_every=4)
    with pytest.raises(ValueError, match="multiple"):
        scan(batched_init_state(cfg, S, "cpu"), *_tensors(scene, 0, 6))
