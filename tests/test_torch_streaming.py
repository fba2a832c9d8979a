"""The port's chunked streaming executor against the JAX reference.

Both executors run the 160x120 configuration of tests/test_streaming.py
(``_cfg``, the synthetic camera's focal length scaled to the 160 px
width) and the 240x320 one of tests/test_pipeline.py (``small_cfg``);
the port's RANSAC is given the minimal sets the reference draws from
``fold_in(PRNGKey(seed), frame_count)``, so the two differ only by
float32 rounding. Bounds: the same success and keyframe decisions on
every frame, inlier counts within 1% + 1 (one correspondence on the 2 px
gate may fall to either side: with gray ingress at 240x320 a frame has
counted 134 against 133, and CPUs differ in where they round), and at
240x320 (72-214 inliers) each pose within 1 cm and 0.5 deg, as
tests/test_torch_pipeline.py holds the tracking step. At 160x120 (6-66
inliers) a frame's pose is not fixed by float32 rounding: frames with
equal inlier counts land up to 2.3 m apart, so there poses are not
compared. On the CPU a chunk is the step in a Python loop; the CUDA
graph of a chunk is held to the eager path in tests/test_torch_cuda.py
and chip_smoke.py.

The default sampler (``pnp.ransac.hash_sampler``) is held to its
contract: the same sets for a given (seed, frame) whatever the chunking,
every index inside [0, n_valid), and each index drawn with a frequency
within 5 binomial standard deviations of uniform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.pipeline import init_state as j_init
from kbslam.streaming import ChunkedStream as JStream
from kbslam.streaming import unpack_mask_bits as j_unpack
from kbslam_torch import config as tconfig
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.pipeline import init_state as t_init
from kbslam_torch.pnp import ransac as transac
from kbslam_torch.slam import SLAM, pose_T, refine_frame_poses
from kbslam_torch.streaming import ChunkedStream as TStream
from kbslam_torch.streaming import make_chunk_step, unpack_mask_bits
from test_async_ba import cfg240
from test_pipeline import small_cfg
from test_streaming import _cfg
from test_torch_pipeline import jax_sampler

torch.set_num_threads(1)


def _tcfg():
    """The port's copy of test_streaming._cfg."""
    return tconfig.SLAMConfig(
        image_height=120, image_width=160,
        orb=tconfig.OrbConfig(num_features=256, num_levels=3,
                              max_features=256),
        pnp=tconfig.PnPConfig(num_hypotheses=64),
        map=tconfig.MapConfig(max_keyframes=8, max_map_points=4096))


def _tcfg_small():
    """The port's copy of test_pipeline.small_cfg."""
    return tconfig.SLAMConfig(
        image_height=240, image_width=320,
        orb=tconfig.OrbConfig(num_features=512, num_levels=4,
                              max_features=512),
        pnp=tconfig.PnPConfig(num_hypotheses=128),
        map=tconfig.MapConfig(max_keyframes=16, max_map_points=8192))


def _tcfg240():
    """The port's copy of test_async_ba.cfg240."""
    return _tcfg_small().replace(ba=tconfig.BAConfig(compact_obs=1024,
                                                     compact_landmarks=1024))


SCENES = {"160x120": (_cfg, _tcfg), "240x320": (small_cfg, _tcfg_small),
          "240x320-ba": (cfg240, _tcfg240)}


def _seq(n, scene="160x120", **kw):
    h, w = (120, 160) if scene == "160x120" else (240, 320)
    return render_sequence(num_frames=n, height=h, width=w,
                           fx=525.0 * w / 640.0, **kw)


def _keyed_sampler(frame_count):
    return jax_sampler(jax.random.fold_in(jax.random.PRNGKey(0),
                                          frame_count))


def _run_pair(seq, n, chunk, scene="160x120", hook=None, **kw):
    """(JAX results, port results, JAX stream, port stream) after feeding
    n frames (with masks when use_mask) and flushing; ``hook(js, ts)``
    runs before the first frame."""
    jcfg, tcfg = (f() for f in SCENES[scene])
    intr = JIntr.from_matrix(seq.K)
    js = JStream(jcfg, intr, j_init(jcfg), chunk=chunk, **kw)
    tintr = TIntr.from_matrix(seq.K)
    ts = TStream(tcfg, tintr, t_init(tcfg, "cpu"), chunk=chunk, **kw)
    ts._run = make_chunk_step(tcfg, tintr, chunk, kw.get("use_mask", False),
                              packed_mask=ts._packed_mask,
                              sampler_for_frame=_keyed_sampler)
    if hook is not None:
        hook(js, ts)
    out = []
    for s in (js, ts):
        got = []
        for i in range(n):
            got += s.feed(seq.rgb[i], seq.depth[i],
                          seq.mask[i] if kw.get("use_mask") else None)
        got += s.flush()
        out.append(got)
    return out[0], out[1], js, ts


def _gap(a, b):
    Ta, Tb = pose_T(a["pose_q"], a["pose_t"]), pose_T(b["pose_q"], b["pose_t"])
    c = np.clip((np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1) / 2, -1, 1)
    return np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]), np.degrees(np.arccos(c))


def _compare(tgot, jgot, n, scene):
    assert len(tgot) == len(jgot) == n
    for i, (t, j) in enumerate(zip(tgot, jgot)):
        assert t["frame"] == j["frame"] == i
        for k in ("success", "added_kf"):
            assert t[k] == j[k], (i, k, t[k], j[k])
        slack = 0.01 * j["num_inliers"] + 1
        assert abs(t["num_inliers"] - j["num_inliers"]) <= slack, (
            i, t["num_inliers"], j["num_inliers"])
        if scene != "160x120":
            dt, dr = _gap(t, j)
            assert dt < 0.01 and dr < 0.5, (i, dt, dr)


@pytest.mark.parametrize("scene", ["160x120", "240x320"])
def test_chunked_stream_matches_reference(scene):
    """25 frames at chunk 8: three chunks and a flushed 1-frame tail."""
    jgot, tgot, js, ts = _run_pair(_seq(25, scene), 25, 8, scene)
    _compare(tgot, jgot, 25, scene)
    assert sum(r["success"] for r in tgot) >= 20
    assert int(ts.state.frame_count) == int(js.state.frame_count) == 25
    assert int(ts.state.map.num_kf) == int(js.state.map.num_kf)


def test_gray_ingress_matches_reference():
    scene = "240x320"
    jgot, tgot, _, _ = _run_pair(_seq(9, scene), 9, 4, scene, gray=True)
    _compare(tgot, jgot, 9, scene)


def test_gray_packed_mask_matches_reference():
    """gray + use_mask: the mask travels bit-packed in both."""
    scene = "240x320"
    jgot, tgot, _, ts = _run_pair(_seq(9, scene, moving_box=True), 9, 4,
                                  scene, gray=True, use_mask=True)
    assert ts._packed_mask
    _compare(tgot, jgot, 9, scene)


@pytest.mark.parametrize("w", [160, 123, 8])
def test_unpack_mask_bits_matches_reference(w):
    rng = np.random.default_rng(3)
    m = (rng.random((24, w)) > 0.4).astype(np.uint8)
    packed = np.packbits(m > 0, axis=-1)
    got = unpack_mask_bits(torch.from_numpy(packed), w).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_unpack(
        jnp.asarray(packed), w)))
    np.testing.assert_array_equal(got, m)


def test_latency_bound():
    """Results arrive no later than 2 chunks after the frame enters."""
    seq = _seq(24)
    cs = TStream(_tcfg(), TIntr.from_matrix(seq.K), t_init(_tcfg(), "cpu"),
                 chunk=4)
    seen = -1
    for i in range(24):
        for d in cs.feed(seq.rgb[i], seq.depth[i]):
            seen = d["frame"]
        if i >= 8:
            assert seen >= i - 8, (i, seen)
    assert [d["frame"] for d in cs.flush()] == list(range(seen + 1, 24))


def _recorded_draws(monkeypatch, run):
    """{frame: DLT index sets} that ``hash_sampler`` drew during run()."""
    import kbslam_torch.pipeline as tpipeline

    draws = {}

    def recording(seed, frame_count):
        inner = transac.hash_sampler(seed, frame_count)

        def sample(*args):
            idx_d, idx_k = inner(*args)
            draws[int(frame_count)] = idx_d.clone()
            return idx_d, idx_k
        return sample

    monkeypatch.setattr(tpipeline, "hash_sampler", recording)
    run()
    return draws


def test_sampler_sets_do_not_depend_on_chunking(monkeypatch):
    """The sets of a frame are a function of (seed, frame): chunks of 3,
    of 8 and the eager per-frame shell draw the same ones and track the
    same."""
    seq = _seq(10)
    intr = TIntr.from_matrix(seq.K)
    runs = []
    for chunk in (3, 8, 0):
        results = []

        def run():
            if chunk:
                cs = TStream(_tcfg(), intr, t_init(_tcfg(), "cpu"),
                             chunk=chunk, seed=5)
                for i in range(10):
                    results.extend(cs.feed(seq.rgb[i], seq.depth[i]))
                results.extend(cs.flush())
            else:
                slam = SLAM(_tcfg(), seq.K, ba_mode="disabled",
                            use_mask=False, seed=5, device="cpu")
                for i in range(10):
                    slam.process(seq.rgb[i], seq.depth[i])
                results.extend(slam.frame_poses)
        runs.append((_recorded_draws(monkeypatch, run), results))
    (d3, r3), (d8, r8), (d0, r0) = runs
    assert sorted(d3) == sorted(d8) == sorted(d0) == list(range(10))
    for f in range(10):
        assert torch.equal(d3[f], d8[f]) and torch.equal(d3[f], d0[f])
    for a, b, T in zip(r3, r8, r0):
        np.testing.assert_array_equal(a["pose_t"], b["pose_t"])
        np.testing.assert_allclose(pose_T(a["pose_q"], a["pose_t"]), T,
                                   atol=1e-6)


@pytest.mark.parametrize("packed", [True, False])
def test_sampler_indices_in_range_and_uniform(packed):
    """n_valid = 37 (not a power of two) among 300 entries, 200 frames of
    128 x 6 DLT lanes: every index is valid, and each of the 37 is drawn
    within 5 sigma of n p, sigma = sqrt(n p (1 - p)), p = 1/37."""
    rng = np.random.default_rng(0)
    if packed:
        valid = torch.arange(300) < 37
    else:
        valid = torch.zeros(300, dtype=torch.bool)
        valid[torch.from_numpy(rng.choice(300, 37, replace=False))] = True
    counts = torch.zeros(300, dtype=torch.int64)
    for f in range(200):
        frame = torch.tensor(f, dtype=torch.int32)
        idx, idx_k = transac.hash_sampler(7, frame)(valid, valid, 128, 4, 6,
                                                    packed)
        assert bool(valid[idx].all()) and bool(valid[idx_k].all())
        assert int(idx.min()) >= 0 and int(idx.max()) < 300
        counts += torch.bincount(idx.reshape(-1), minlength=300)
    n, p = 200 * 128 * 6, 1 / 37
    c = counts[valid].double()
    assert int(counts[~valid].sum()) == 0
    assert float((c - n * p).abs().max()) < 5 * np.sqrt(n * p * (1 - p)), c


def test_async_on_the_hard_scene():
    """tests/test_streaming.py:193-257 on the port: solves run and never
    raise the cost; the chunked async online ATE is no worse than the
    chunked VO-only one (x1.05 + 1 mm); the chunked refined trajectory is
    within 10% + 1 mm of the per-frame async shell's."""
    from kbslam_torch.eval.trajectory import ate_rmse

    cfg = tconfig.SLAMConfig(
        image_height=240, image_width=320,
        orb=tconfig.OrbConfig(num_features=512, num_levels=4,
                              max_features=512),
        pnp=tconfig.PnPConfig(num_hypotheses=128),
        map=tconfig.MapConfig(max_keyframes=16, max_map_points=8192),
        ba=tconfig.BAConfig(compact_obs=1024, compact_landmarks=1024))
    seq = render_sequence(num_frames=40, height=240, width=320,
                          scene="spheres", depth_noise_mm=2.0,
                          depth_dropout=0.02, seed=0)
    intr = TIntr.from_matrix(seq.K)
    gt = seq.poses[:, :3, 3]

    def run_chunked(ba_mode):
        cs = TStream(cfg, intr, t_init(cfg, "cpu"), chunk=8, ba_mode=ba_mode)
        got = []
        for i in range(40):
            got += cs.feed(seq.rgb[i], seq.depth[i])
        got += cs.flush()
        assert len(got) == 40
        est = [pose_T(r["pose_q"], r["pose_t"]) for r in got]
        anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
                   for r in got]
        refined = refine_frame_poses(est, anchors, cs.state.map)
        return (ate_rmse(np.stack(est)[:, :3, 3], gt),
                ate_rmse(refined[:, :3, 3], gt), cs)

    ate_vo, _, _ = run_chunked("off")
    ate_ba, ate_ba_ref, cs = run_chunked("async")
    assert len(cs.ba_stats) >= 2, "async BA never ran on the chunked path"
    for s in cs.ba_stats:
        assert s["final_cost"] <= s["initial_cost"] * 1.001
    assert ate_ba <= 1.05 * ate_vo + 1e-3, (ate_ba, ate_vo)

    slam = SLAM(cfg, seq.K, ba_mode="async", use_mask=False, device="cpu")
    for i in range(40):
        slam.process(seq.rgb[i], seq.depth[i])
    slam.finish()
    ate_pf_ref = ate_rmse(slam.refined_trajectory()[:, :3, 3], gt)
    assert ate_ba_ref <= 1.10 * ate_pf_ref + 1e-3, (ate_ba_ref, ate_pf_ref)


def test_chunked_async_matches_reference():
    """ba_mode="async" in both executors: the 40-frame 240x320 sequence
    and configuration of tests/test_async_ba.py (``cfg240``), chunk 8,
    the reference's minimal sets in the port. The reference merges a
    solve at the first chunk boundary that finds it finished, the port on
    the CPU at the next one; the reference's solve is made to finish at
    dispatch, so both merge at the next boundary. Held: the frame gates
    of ``_compare`` (decisions, inliers within 1% + 1, poses within 1 cm
    and 0.5 deg), solves dispatched after the same drained frames and
    equal in number (>= 2) and pruning counts, and every frame pose
    re-expressed against the final refined keyframes
    (``refine_frame_poses``) within 1 cm."""
    dispatched = {"jax": [], "port": []}

    def hook(js, ts):
        solve, dispatch = js._ba_solve, ts._async.dispatch

        def j_solve(m):
            dispatched["jax"].append(js._frame)
            return jax.block_until_ready(solve(m))

        def t_dispatch(m):
            dispatched["port"].append(ts._frame)
            dispatch(m)

        js._ba_solve, ts._async.dispatch = j_solve, t_dispatch

    seq = render_sequence(num_frames=40, height=240, width=320)
    jgot, tgot, js, ts = _run_pair(seq, 40, 8, "240x320-ba", hook=hook,
                                   ba_mode="async")
    _compare(tgot, jgot, 40, "240x320-ba")
    assert dispatched["port"] == dispatched["jax"]
    assert len(ts.ba_stats) == len(js.ba_stats) == len(dispatched["port"]) >= 2
    assert ([s["num_pruned"] for s in ts.ba_stats]
            == [s["num_pruned"] for s in js.ba_stats])

    def refined(got, m):
        est = [pose_T(r["pose_q"], r["pose_t"]) for r in got]
        anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
                   for r in got]
        return refine_frame_poses(est, anchors, m)[:, :3, 3]

    gap = np.abs(refined(tgot, ts.state.map) - refined(
        jgot, convert.map_to_torch(js.state.map, "cpu"))).max()
    assert gap < 0.01, gap


def test_unported_options_raise():
    """What the shells still refuse, as the reference does: dense ICP
    without dense mapping or with an unknown mode, and dense ICP on the
    chunked path (``ValueError``). The monolithic volume, the submap
    atlas, dense ICP per frame, culling, loop closure and relocalization
    are ported and accepted."""
    import dataclasses

    seq_K = np.array([[200.0, 0, 80], [0, 200, 60], [0, 0, 1]])
    base = _tcfg()
    dense = base.replace(dense=dataclasses.replace(base.dense, enabled=True))
    atlas = dense.replace(dense=dataclasses.replace(dense.dense,
                                                    submap_every=2))
    icp = dense.replace(dense_icp=dataclasses.replace(base.dense_icp,
                                                      mode="rescue"))
    no_dense = base.replace(dense_icp=icp.dense_icp)
    bad_mode = dense.replace(dense_icp=dataclasses.replace(base.dense_icp,
                                                           mode="polish"))
    for cfg, message in ((icp, "per-frame path only"),
                         (no_dense, "requires dense.enabled"),
                         (bad_mode, "unknown dense_icp.mode")):
        with pytest.raises(ValueError, match=message):
            TStream(cfg, TIntr.from_matrix(seq_K), t_init(base, "cpu"))
    for cfg, message in ((no_dense, "requires dense.enabled"),
                         (bad_mode, "unknown dense_icp.mode")):
        with pytest.raises(ValueError, match=message):
            SLAM(cfg, seq_K, device="cpu")
    assert TStream(dense, TIntr.from_matrix(seq_K),
                   t_init(base, "cpu")).tsdf is not None
    assert SLAM(dense, seq_K, device="cpu").tsdf is not None
    assert TStream(atlas, TIntr.from_matrix(seq_K),
                   t_init(base, "cpu")).atlas is not None
    assert SLAM(atlas, seq_K, device="cpu").atlas is not None
    assert SLAM(icp, seq_K, device="cpu")._icp is not None
    ported = base.replace(cull=dataclasses.replace(base.cull, enabled=True),
                          loop=dataclasses.replace(base.loop, enabled=True,
                                                   reloc_after=3))
    cs = TStream(ported, TIntr.from_matrix(seq_K), t_init(base, "cpu"))
    assert cs._cull is not None and cs._loop is not None
    assert cs._reloc is not None
    slam = SLAM(ported, seq_K, device="cpu")
    assert slam._cull is not None and slam._loop is not None
    assert slam._reloc is not None


def test_kf_tick_order_and_flush_drain():
    """kbslam/streaming.py:467-501's order in a chunk-late keyframe tick
    (cull, merge, loop tick, dispatch), and flush() merging the last
    solve and draining the loop queue after the last merge
    (kbslam/streaming.py:596-611)."""
    from test_torch_slam import _in_order, _order_cfg, _record

    seq = _seq(24)
    cs = TStream(_order_cfg(), TIntr.from_matrix(seq.K),
                 t_init(_order_cfg(), "cpu"), chunk=4, ba_mode="async")
    log, ticks = [], [0]
    _record(log, cs, lambda: ticks[0])
    kf_tick = cs._kf_tick

    def counted(*a, **k):       # the clock: one tick per _kf_tick call
        ticks[0] += 1
        return kf_tick(*a, **k)

    cs._kf_tick = counted
    for i in range(24):
        cs.feed(seq.rgb[i], seq.depth[i])
    cs.flush()
    del cs._kf_tick
    names = [n for n, _ in log]
    assert {"cull", "merge", "loop", "dispatch"} <= set(names), names
    assert _in_order(log), log
    assert names[-1] == "loop" and "merge" in names[-3:]
    assert cs._async.inflight is None and cs._loop._pending == []
    assert cs._loop._num_insertions == int(cs.state.map.num_kf)
