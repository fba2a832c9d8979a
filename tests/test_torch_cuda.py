"""Tests of the port on a CUDA device (marker ``cuda``; they skip
without one). This file imports neither JAX nor the kbslam package, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from kbslam_torch import config
from kbslam_torch.frontend import brief as tbrief
from kbslam_torch.frontend.image import pyramid_sizes
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.io import synthetic
from kbslam_torch.ops import describe as tdescribe
from kbslam_torch.ops import patches as tpatches
from kbslam_torch.ba.local_ba import local_ba
from kbslam_torch.eval import trajectory
from kbslam_torch.mapping.state import MapState
from kbslam_torch.pipeline import init_state, make_track_step
from kbslam_torch.pnp.ransac import hash_sampler
from kbslam_torch.slam import SLAM, pose_T

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from kbslam_torch.device import pick_device

    return pick_device("cuda")


def _inputs(h, w, n, dev, seed=0):
    """A stacked [8, h, w] pyramid and n clamped patch origins, a third
    at or past a level's far edge."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(pyramid_sizes(h, w, 8, 1.2), np.int32)
    stacked = np.zeros((8, h, w), np.float32)
    for lv, (hl, wl) in enumerate(sizes):
        stacked[lv, :hl, :wl] = rng.random((hl, wl), np.float32) * 255
    level = rng.integers(0, 8, n).astype(np.int32)
    hw = sizes[level]
    xy = rng.random((n, 2)) * hw[:, ::-1]
    edge = rng.random(n) < 0.33
    xy[edge] = hw[edge, ::-1] - 1 + rng.integers(-3, 25, (edge.sum(), 2))
    base = np.round(xy).astype(np.int32)
    x0 = np.clip(base[:, 0] - 20, 0, np.maximum(hw[:, 1] - 40, 0))
    y0 = np.clip(base[:, 1] - 20, 0, np.maximum(hw[:, 0] - 40, 0))
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=a.dtype)).to(dev)
            for a in (stacked, level, y0.astype(np.int32),
                      x0.astype(np.int32))]


@pytest.mark.parametrize("h,w,n", [(480, 640, 3072), (480, 640, 3071),
                                   (64, 96, 130), (64, 96, 1)])
def test_kernel_equals_plain_and_counts(cuda_device, h, w, n):
    args = _inputs(h, w, n, cuda_device)
    before = tpatches.launches
    got = tpatches.extract_patches(*args)
    torch.cuda.synchronize()
    assert tpatches.launches == before + 1
    assert torch.equal(got, tpatches.extract_patches_reference(*args))


def test_kernel_rejects_bad_input(cuda_device):
    st, lv, yy, xx = _inputs(64, 96, 8, cuda_device)
    before = tpatches.launches
    for bad in ((st.double(), lv, yy, xx), (st, lv.long(), yy, xx),
                (st, lv.cpu(), yy, xx), (st[:, :30].contiguous(), lv, yy, xx),
                (st.transpose(1, 2), lv, yy, xx), (st, lv[:4], yy, xx)):
        with pytest.raises(ValueError):
            tpatches.extract_patches(*bad)
    assert tpatches.launches == before


def _describe_gates(got, ref):
    """chip_smoke.py's gates: angles within 2e-4 rad; on every keypoint
    whose twin bin fraction lies 1e-3 or more from a rounding edge, the
    same bin and all 256 bits equal (nearer an edge the twin's division
    by a scalar, a multiply by the reciprocal on the card, may move the
    bin); at least 99.9% of keypoints bit-identical."""
    (ga, gb), (ra, rb) = got, ref
    assert ga.shape == ra.shape and gb.shape == rb.shape
    assert gb.dtype == torch.uint8 and int(gb.max()) <= 1
    assert float((ga - ra).abs().max()) <= 2e-4
    frac = tbrief.angle_frac(ra).cpu().double().numpy()
    away = np.abs(frac - np.floor(frac) - 0.5) >= 1e-3
    kbin = tbrief.angle_bins(ga.cpu()).numpy()  # the kernel's float32 ops
    rbin = tbrief.angle_bins(ra).cpu().numpy()  # the bins the twin used
    same = (gb == rb).all(1).cpu().numpy()
    assert not ((kbin != rbin) & away).any()
    assert not (~same & away).any()
    assert same.mean() >= 0.999


@pytest.mark.parametrize("h,w,n", [(480, 640, 3072), (480, 640, 3071),
                                   (64, 96, 130), (64, 96, 1)])
def test_describe_kernel_matches_plain_and_counts(cuda_device, h, w, n):
    args = _inputs(h, w, n, cuda_device, seed=n)
    before = tdescribe.launches
    got = tdescribe.describe_keypoints(*args)
    torch.cuda.synchronize()
    assert tdescribe.launches == before + 1
    _describe_gates(got, tdescribe.describe_keypoints_reference(*args))


def test_describe_kernel_rejects_bad_input(cuda_device):
    st, lv, yy, xx = _inputs(64, 96, 8, cuda_device)
    before = tdescribe.launches
    for bad in ((st.double(), lv, yy, xx), (st, lv.long(), yy, xx),
                (st, lv.cpu(), yy, xx), (st[:, :30].contiguous(), lv, yy, xx),
                (st.transpose(1, 2), lv, yy, xx), (st, lv[:4], yy, xx),
                (st[:, :, :94].contiguous(), lv, yy, xx),
                (st, lv, torch.stack([yy, yy], 1)[:, 0], xx),
                (torch.cat([st.new_zeros(1), st.reshape(-1)])[1:].view(
                    st.shape), lv, yy, xx)):
        with pytest.raises(ValueError):
            tdescribe.describe_keypoints(*bad)
    assert tdescribe.launches == before


def _cpu_sampler(frame_count):
    """Minimal sets drawn on the CPU, then moved to the tensors' device,
    so CPU and CUDA runs solve the same hypotheses."""
    cpu = hash_sampler(1000, torch.tensor(frame_count, dtype=torch.int32))

    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        dev = valid.device
        idx_d, idx_k = cpu(valid.cpu(), None if pool is None else pool.cpu(),
                           k_dlt, k_kabsch, set_size, packed)
        return idx_d.to(dev), None if idx_k is None else idx_k.to(dev)
    return sample


def _cfg240():
    return config.SLAMConfig(
        image_height=240, image_width=320,
        orb=config.OrbConfig(num_features=512, num_levels=4, max_features=512),
        map=config.MapConfig(max_keyframes=16, max_map_points=8192))


def test_tracking_step_cuda_matches_cpu(cuda_device):
    """The tracking step on the card against the same step on the CPU
    (the CPU runs the plain describe twin): the same keyframe and success
    decisions, poses within 1 cm and 0.5 deg (float32 sums in another
    order on the card). The card's step launches the describe kernel
    once per frame and the patch kernel never."""
    seq = synthetic.render_sequence(num_frames=12, height=240, width=320)
    cfg = _cfg240()
    intr = Intrinsics.from_matrix(seq.K)
    runs = {}
    for dev in (torch.device("cpu"), cuda_device):
        step = make_track_step(cfg, intr, use_mask=False,
                               sampler_for_frame=_cpu_sampler)
        state = init_state(cfg, dev)
        outs = []
        before = (tdescribe.launches, tpatches.launches)
        for i in range(len(seq.rgb)):
            state, o = step(state, torch.from_numpy(seq.rgb[i]).to(dev),
                            torch.from_numpy(seq.depth[i].astype(np.int32)).to(dev))
            outs.append((bool(o.success), bool(o.added_kf),
                         pose_T(o.pose_q.cpu().numpy(), o.pose_t.cpu().numpy())))
        runs[dev.type] = (outs, (tdescribe.launches - before[0],
                                 tpatches.launches - before[1]))
    assert runs["cpu"][1] == (0, 0)
    assert runs["cuda"][1] == (len(seq.rgb), 0)
    for (sc, kc, Tc), (sg, kg, Tg) in zip(runs["cpu"][0], runs["cuda"][0]):
        assert (sc, kc) == (sg, kg)
        assert np.linalg.norm(Tc[:3, 3] - Tg[:3, 3]) < 0.01
        cosang = (np.trace(Tc[:3, :3].T @ Tg[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 0.5
    assert all(s for s, _, _ in runs["cuda"][0][1:])


def test_local_ba_cuda_matches_cpu_without_host_sync(cuda_device):
    """One local BA on a tracked five-keyframe map, on the card and on the
    CPU: the same pruning and landmark references and final costs within
    1e-3; poses within 1e-4 m after 3 LM trips (later trips walk the
    plane scene's near-null valley, where the card's atomic sums and the
    CPU's ordered ones end at different points of equal cost); the
    card's solve makes no host sync."""
    seq = synthetic.render_sequence(num_frames=60, height=240, width=320)
    slam = SLAM(_cfg240(), seq.K, ba_mode="disabled", use_mask=False,
                device="cpu")
    for i in range(60):
        slam.process(seq.rgb[i], seq.depth[i])
        if slam.num_keyframes == 5:
            break
    cpu_map, intr, cfg = slam.state.map, slam.intr, slam.config.ba
    gpu_map = MapState(*(t.to(cuda_device) for t in cpu_map))
    local_ba(gpu_map, intr, cfg)          # warm-up: library handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, stats = local_ba(gpu_map, intr, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref, ref_stats = local_ba(cpu_map, intr, cfg)
    assert int(stats.num_pruned) == int(ref_stats.num_pruned)
    assert torch.equal(out.kf_mp.cpu(), ref.kf_mp)
    f, fr = float(stats.final_cost), float(ref_stats.final_cost)
    assert abs(f - fr) <= 1e-3 * abs(fr)
    assert f <= float(stats.initial_cost)
    cfg3 = dataclasses.replace(cfg, max_iterations=3)
    out3, _ = local_ba(gpu_map, intr, cfg3)
    ref3, _ = local_ba(cpu_map, intr, cfg3)
    assert float((out3.kf_t.cpu() - ref3.kf_t).abs().max()) < 1e-4
    assert float((out3.mp_pos.cpu() - ref3.mp_pos).abs().max()) < 1e-4


def test_async_ba_on_a_side_stream(cuda_device):
    """ba_mode="async" on the card: the solve replays a captured graph on
    the side stream, is merged after an event poll, and the run meets the
    gates of tests/test_async_ba.py."""
    seq = synthetic.render_sequence(num_frames=40, height=240, width=320)
    slam = SLAM(_cfg240(), seq.K, ba_mode="async", use_mask=False,
                device=cuda_device)
    for i in range(40):
        slam.process(seq.rgb[i], seq.depth[i])
    slam.finish()
    assert slam._async._graph is not None and slam._async._stream is not None
    assert slam._async.inflight is None and len(slam.ba_stats) >= 1
    est = np.stack(slam.frame_poses)
    assert trajectory.ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3]) < 0.05
    for st in slam.ba_stats:
        assert st["final_cost"] <= st["initial_cost"] * 1.001


def test_chunk_graph_equals_the_eager_step(cuda_device):
    """ChunkedStream on the card (chunk 8: two replays of the captured
    graph, then 4 eager tail frames) against the eager per-frame step on
    the card: the same decisions and inlier counts, poses within 1e-5,
    and the same minimal sets on the CPU and the card."""
    from kbslam_torch.slam import output_to_host
    from kbslam_torch.streaming import ChunkedStream

    seq = synthetic.render_sequence(num_frames=20, height=240, width=320)
    cfg = _cfg240()
    intr = Intrinsics.from_matrix(seq.K)
    step = make_track_step(cfg, intr, use_mask=False)
    state, ref = init_state(cfg, cuda_device), []
    for i in range(20):
        state, o = step(state, torch.from_numpy(seq.rgb[i]).to(cuda_device),
                        torch.from_numpy(seq.depth[i].astype(np.int32)).to(
                            cuda_device))
        ref.append(output_to_host(o))
    cs = ChunkedStream(cfg, intr, init_state(cfg, cuda_device), chunk=8)
    got = []
    for i in range(20):
        got += cs.feed(seq.rgb[i], seq.depth[i])
    got += cs.flush()
    assert cs._graph is not None and len(got) == 20
    for g, r in zip(got, ref):
        assert (g["success"], g["added_kf"], g["num_inliers"]) == (
            bool(r["success"]), bool(r["added_kf"]), int(r["num_inliers"]))
        assert np.abs(g["pose_t"] - r["pose_t"]).max() <= 1e-5
        assert np.abs(g["pose_q"] - r["pose_q"]).max() <= 1e-5
    assert int(cs.state.frame_count) == 20
    valid = (torch.arange(512) % 5) != 0
    for f in range(4):
        fc = torch.tensor(f, dtype=torch.int32)
        a = hash_sampler(3, fc)(valid, valid, 16, 48, 6, False)
        b = hash_sampler(3, fc.to(cuda_device))(
            valid.to(cuda_device), valid.to(cuda_device), 16, 48, 6, False)
        assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))


def test_graphed_solve_equals_the_eager_solve(cuda_device):
    """local_ba captured as one CUDA graph (GraphedLocalBA) against the
    eager solve on the same five-keyframe map: equal bit for bit (the
    sums by id add in a fixed order, ``ops.incidence.SumById``)."""
    from kbslam_torch.ba.local_ba import GraphedLocalBA

    seq = synthetic.render_sequence(num_frames=60, height=240, width=320)
    slam = SLAM(_cfg240(), seq.K, ba_mode="disabled", use_mask=False,
                device=cuda_device)
    for i in range(60):
        slam.process(seq.rgb[i], seq.depth[i])
        if slam.num_keyframes == 5:
            break
    m, intr, cfg = slam.state.map, slam.intr, slam.config.ba
    eager, eager_stats = local_ba(m, intr, cfg)
    g = GraphedLocalBA(cfg, intr, m)
    g.snapshot(m)
    res, stats = g.solve()
    torch.cuda.synchronize()
    for a, b in zip(list(res) + list(stats), list(eager) + list(eager_stats)):
        assert torch.equal(a, b)


def test_sum_by_id_on_the_card_equals_the_cpu(cuda_device):
    """The plan and the segment sum make no host sync, and add in the same
    order on the card as on the CPU, so the sums are equal bit for bit."""
    from kbslam_torch.ops.incidence import SumById

    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(-2, 4100, 4096).astype(np.int32))
    values = torch.from_numpy(rng.standard_normal((4096, 42))
                              .astype(np.float32))
    ref = SumById(ids, 4096)(values, exact=True)
    ids_d, values_d = ids.to(cuda_device), values.to(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = SumById(ids_d, 4096)(values_d, exact=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), ref)


def test_capture_survives_a_dead_graph_in_a_cycle(cuda_device):
    """A captured graph held by a dead reference cycle, and the collector
    set to run at almost every allocation: ``device.graph_capture`` still
    captures (freeing a graph inside a capture would fail it), and the
    replay computes what the eager ops do."""
    import gc

    from kbslam_torch.device import graph_capture

    x = torch.arange(8.0, device=cuda_device)

    def captured():
        g = torch.cuda.CUDAGraph()
        with graph_capture(g):
            y = x
            for _ in range(50):
                y = y * 0.5 + 1.0
        return g, y

    cycle = {"graph": captured()}
    cycle["self"] = cycle
    del cycle
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g, y = captured()
    finally:
        gc.set_threshold(*threshold)
    g.replay()
    ref = x
    for _ in range(50):
        ref = ref * 0.5 + 1.0
    assert torch.equal(y, ref)


def test_chunked_correction_lands_in_the_static_buffers(cuda_device):
    """A map change made between replays (here a loop runner that moves
    every keyframe by 10 cm after the second chunk) must reach the next
    replay: the captured chunk reads the stream's static buffers, so the
    change is copied into them (``assign_state``). The replayed stream
    equals the same stream run eagerly (``graph=False``) frame by frame,
    and its state tensors are the same objects throughout."""
    from kbslam_torch.streaming import ChunkedStream

    seq = synthetic.render_sequence(num_frames=32, height=240, width=320)
    cfg = _cfg240().replace(loop=dataclasses.replace(
        _cfg240().loop, enabled=True))
    intr = Intrinsics.from_matrix(seq.K)
    runs = {}
    for graph in (True, False):
        cs = ChunkedStream(cfg, intr, init_state(cfg, cuda_device), chunk=8,
                           graph=graph)
        ptrs = [t.data_ptr() for t in cs.state.map]
        moved = []

        def tick(state, frame, inflight, cs=cs, moved=moved):
            if frame >= 8 and not moved:
                moved.append(cs.replays)
                m = state.map
                return state._replace(map=m._replace(kf_t=m.kf_t + 0.1))
            return state

        cs._loop.tick = tick
        got = []
        for i in range(32):
            got += cs.feed(seq.rgb[i], seq.depth[i])
        got += cs.flush()
        assert [t.data_ptr() for t in cs.state.map] == ptrs
        runs[graph] = (got, moved, cs.replays)
    (g, moved, replays), (e, _, _) = runs[True], runs[False]
    assert moved and moved[0] < replays          # a replay came after it
    assert len(g) == len(e) == 32
    for a, b in zip(g, e):
        assert (a["success"], a["added_kf"], a["num_inliers"]) == (
            b["success"], b["added_kf"], b["num_inliers"])
        assert np.abs(a["pose_t"] - b["pose_t"]).max() <= 1e-5
        assert np.abs(a["anchor_t"] - b["anchor_t"]).max() <= 1e-5


def test_graphed_close_equals_the_eager_close(cuda_device):
    """The loop close captured as one CUDA graph (``CapturedCall``, as
    the runner replays it on the card) against the eager close on a
    tracked map with a loop edge from the newest keyframe to the oldest,
    its measured pose moved by 5 cm and 2 deg: equal bit for bit, and
    within 1e-4 m of the close on the CPU."""
    from kbslam_torch.device import CapturedCall
    from kbslam_torch.geom.se3 import SE3
    from kbslam_torch.loop.closure import close_loop

    seq = synthetic.render_sequence(num_frames=16, height=240, width=320)
    cfg = _cfg240().replace(policy=config.KeyframePolicyConfig(
        min_frame_gap=3, rotation_threshold_deg=2.0))
    slam = SLAM(cfg, seq.K, ba_mode="disabled", use_mask=False,
                device=cuda_device)
    track_all = [slam.process(seq.rgb[i], seq.depth[i]) for i in range(16)]
    assert sum(d["added_kf"] for d in track_all) >= 4
    m = slam.state.map
    j = (slam.num_keyframes - 1) % m.capacity_kf
    rel = SE3(m.kf_q[0], m.kf_t[0]).inverse().compose(SE3(m.kf_q[j],
                                                          m.kf_t[j]))
    nudge = SE3.exp(torch.tensor([0.05, 0, 0, 0, np.radians(2.0), 0],
                                 dtype=torch.float32, device=cuda_device))
    rel = nudge.compose(rel).normalize()
    i32 = dict(dtype=torch.int32, device=cuda_device)
    args = (torch.tensor(0, **i32), torch.tensor(j, **i32), rel.q, rel.t,
            torch.tensor(True, device=cuda_device))
    def close(*a):
        return close_loop(*a[:5], loop_ok=a[5])

    eager, eager_stats = close(m, *args)
    got, stats = CapturedCall(close, m, *args)(m, *args)
    torch.cuda.synchronize()
    for name in ("kf_q", "kf_t", "mp_pos"):
        assert torch.equal(getattr(got, name), getattr(eager, name))
    for a, b in zip(stats, eager_stats):
        assert torch.equal(a, b)
    cpu = MapState(*(t.cpu() for t in m))
    ref, _ = close_loop(cpu, *(a.cpu() for a in args[:4]),
                        loop_ok=args[4].cpu())
    assert float((got.kf_t.cpu() - ref.kf_t).abs().max()) < 1e-4
    assert float((got.mp_pos.cpu() - ref.mp_pos).abs().max()) < 1e-4
    assert float((got.kf_t.cpu() - cpu.kf_t).abs().max()) > 1e-3


def test_global_ba_on_the_card_graphed_and_against_the_cpu(cuda_device):
    """The synthetic global problem: the solve makes no host sync, its
    replay equals the eager solve bit for bit, and it agrees with the CPU
    at a fixed trip count (costs within 1e-4 relative)."""
    from kbslam_torch.ba import global_ba as gba
    from kbslam_torch.device import CapturedCall

    data, intr, _ = gba.make_synthetic_global_problem(
        np.random.default_rng(0), "cpu")
    dev = gba.GlobalBAData(*(x.to(cuda_device) for x in data))

    def solve(d):
        return gba.global_ba_solve(d, intr, iters=4, pcg_iters=3,
                                   pcg_tol=0.0, return_stats=True)

    solve(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, costs, stats = solve(dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = CapturedCall(solve, dev)(dev)
    torch.cuda.synchronize()
    for a, b in zip(list(out) + [costs] + list(stats),
                    list(got[0]) + [got[1]] + list(got[2])):
        assert torch.equal(a, b)
    _, ref, ref_stats = solve(data)
    np.testing.assert_allclose(costs.cpu().numpy(), ref.numpy(), rtol=1e-4)
    assert torch.equal(stats.retries.cpu(), ref_stats.retries)


def test_multistream_side_streams_serial_and_single_agree(cuda_device):
    """Two tiny streams through the per-stream yardstick: the side-stream
    replays, the serial replays and each stream's own eager steps (the
    same draws) agree bit for bit."""
    from kbslam_torch.parallel.multistream import (batched_init_state,
                                                   make_perstream_step)
    from kbslam_torch.pipeline import track_step

    S, T = 2, 4
    cfg = config.tiny_config(height=120, width=160)
    seqs = [synthetic.render_sequence(num_frames=T, height=120, width=160,
                                      fx=130.0, seed=s) for s in range(S)]
    intr = Intrinsics.create(130.0, 130.0, 79.5, 59.5)
    rgb = torch.from_numpy(np.stack([np.stack([s.rgb[t] for s in seqs])
                                     for t in range(T)])).to(cuda_device)
    dep = torch.from_numpy(np.stack([np.stack([s.depth[t] for s in seqs])
                                     for t in range(T)]).astype(np.int32)
                           ).to(cuda_device)
    step = make_perstream_step(cfg, intr, S)
    runs = []
    for serial in (False, True):
        state, outs = batched_init_state(cfg, S, cuda_device), []
        for t in range(T):
            state, out = step(state, rgb[t], dep[t], serial=serial)
            outs.append(out)
        runs.append(outs)
    for a, b in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for i in range(S):
        st = init_state(cfg, cuda_device)
        for t in range(T):
            st, o = track_step(st, rgb[t, i], dep[t, i], None, intr, cfg,
                               hash_sampler(0, st.frame_count * S + i))
            assert all(torch.equal(x, y[i]) for x, y in zip(o, runs[0][t]))


@pytest.mark.parametrize("n", [3072, 3071, 1])
def test_batched_describe_launch_equals_single_launches(cuda_device, n):
    """Three pyramids in one launch: each stream bit-equal to its own
    launch, phase 4's gates against the twin, one launch counted; a
    batch the kernel cannot take raises and launches nothing."""
    parts = [_inputs(480, 640, n, cuda_device, seed=n + i) for i in range(3)]
    args = [torch.stack(x).contiguous() for x in zip(*parts)]
    before = tdescribe.launches
    angle, bits = tdescribe.describe_keypoints(*args)
    torch.cuda.synchronize()
    assert tdescribe.launches == before + 1
    assert angle.shape == (3, n) and bits.shape == (3, n, 256)
    for i, p in enumerate(parts):
        a, b = tdescribe.describe_keypoints(*p)
        assert torch.equal(a, angle[i]) and torch.equal(b, bits[i])
    ref = tdescribe.describe_keypoints_reference(*args)
    _describe_gates((angle.reshape(-1), bits.reshape(-1, 256)),
                    (ref[0].reshape(-1), ref[1].reshape(-1, 256)))
    st, lv, yy, xx = args
    before = tdescribe.launches
    for bad in ((st, lv[:2], yy[:2], xx[:2]),
                (st, torch.stack([lv, lv], -1)[..., 0], yy, xx),
                (st, lv[:, :-1].contiguous(), yy, xx),
                (st[..., :634].contiguous(), lv, yy, xx)):
        with pytest.raises(ValueError):
            tdescribe.describe_keypoints(*bad)
    assert tdescribe.launches == before


def test_batched_step_graph_equals_the_eager_batched_step(cuda_device):
    """Two tiny streams through ``make_multistream_step`` and one block
    of ``make_multistream_scan`` on the card (one CUDA graph each)
    against ``track_step_batched`` and the same block called eagerly on
    the card: bit for bit; a replay runs the describe kernel once per
    step; every stream tracks."""
    from kbslam_torch.parallel.multistream import (batched_init_state,
                                                   make_multistream_scan,
                                                   make_multistream_step)
    from kbslam_torch.pipeline import clone_state, track_step_batched

    S, T, K = 2, 6, 4
    cfg = config.tiny_config(height=120, width=160)
    seqs = [synthetic.render_sequence(num_frames=T, height=120, width=160,
                                      fx=130.0, seed=s) for s in range(S)]
    intr = Intrinsics.create(130.0, 130.0, 79.5, 59.5)
    rgb = torch.from_numpy(np.stack([np.stack([s.rgb[t] for s in seqs])
                                     for t in range(T)])).to(cuda_device)
    dep = torch.from_numpy(np.stack([np.stack([s.depth[t] for s in seqs])
                                     for t in range(T)]).astype(np.int32)
                           ).to(cuda_device)
    step = make_multistream_step(cfg, intr, S)
    state = batched_init_state(cfg, S, cuda_device)
    ref = batched_init_state(cfg, S, cuda_device)
    for t in range(2):
        state, out = step(state, rgb[t], dep[t])
        c = ref.frame_count * S + torch.arange(S, dtype=torch.int32,
                                               device=cuda_device)
        ref, ref_out = track_step_batched(ref, rgb[t], dep[t], None, intr,
                                          cfg, hash_sampler(0, c))
        assert all(torch.equal(x, y) for x, y in zip(out, ref_out))
    assert step.program.replays == 2 and bool(out.success.all())
    scan = make_multistream_scan(cfg, intr, S, apply_every=K)
    st_g, ninl_g = scan(clone_state(state), rgb[2:], dep[2:])
    before = tdescribe.launches
    st_e, (ninl_e,) = scan.program._body(clone_state(state), rgb[2:],
                                         dep[2:])
    assert tdescribe.launches == before + K
    assert torch.equal(ninl_g, ninl_e) and bool((ninl_g > 0).all())
    for a, b in zip(list(st_g.map) + list(st_g[1:]),
                    list(st_e.map) + list(st_e[1:])):
        assert torch.equal(a, b)


def _nccl_solve_rank(group):
    """One rank of an NCCL group: the synthetic global problem solved
    unsharded, camera-sharded and landmark-sharded on this rank's card."""
    from kbslam_torch.ba import global_ba as gba

    data, intr, _ = gba.make_synthetic_global_problem(
        np.random.default_rng(0), group.device)
    res = {}
    for name, g, ls in (("one", None, False), ("cameras", group, False),
                        ("landmarks", group, True)):
        d = data if g is None else gba.shard_global_data(data, g)
        out, costs, stats = gba.global_ba_solve(
            d, intr, iters=4, pcg_iters=25, return_stats=True, group=g,
            landmark_sharded=ls)
        if g is not None:
            out = gba.gather_global_data(out, g)
        res[name] = [t.cpu() for t in list(out) + [costs] + list(stats)]
    res["counts"] = {op: list(c) for op, c in group.counts.items()}
    res["backend"] = str(torch.distributed.get_backend())
    return res


def test_nccl_group_of_one_equals_the_unsharded_solve(cuda_device):
    """An NCCL group of one rank (``parallel.dist.spawn`` on the card):
    the camera-sharded and the landmark-sharded solve equal the unsharded
    one bit for bit, and the collectives ran."""
    from kbslam_torch.parallel import dist

    (res,) = dist.spawn(_nccl_solve_rank, 1, "cuda", timeout_s=300)
    assert res["backend"] == "nccl"
    for name in ("cameras", "landmarks"):
        assert all(torch.equal(a, b) for a, b in zip(res[name], res["one"]))
    assert res["counts"]["all_reduce"][0] > 0
    assert res["counts"]["reduce_scatter"][0] > 0


@pytest.mark.parametrize("case", ["every_program", "atlas"])
def test_graphed_shell_equals_the_eager_drive(cuda_device, case):
    """SLAM on the card, each program a replayed CUDA graph, against the
    same shell with its programs called eagerly on the card
    (``EagerSLAM``; tests/test_torch_slam_graph.py holds the shell
    against a drive of the eager functions on the CPU): poses,
    diagnostics, ba_stats, events, final map and dense model bit-equal,
    the live tensors never moved, one tracking replay per frame.
    "every_program": the lost-and-found scene with BA, cull, loop,
    relocalization, the volume, ICP rescue and a resume through the
    ``state`` setter; "atlas": the submap atlas and its ICP rescue."""
    from kbslam_torch.device import tensor_leaves
    from test_torch_slam_graph import (EagerSLAM, assert_shell_equals_drive,
                                       atlas_case, every_program_cfg,
                                       lost_and_found, run_record,
                                       shell_run)

    if case == "every_program":
        cfg, (K, rgb, dep), masks, rewind = (every_program_cfg(),
                                             lost_and_found(), None, (25, 30))
    else:
        (cfg, K, rgb, dep, masks), rewind = atlas_case(), None
    slam = SLAM(cfg, K, device=cuda_device)
    ptrs = []
    shell_run(slam, rgb, dep, masks, rewind=rewind, on_frame=lambda s: (
        ptrs.append([t.data_ptr() for t in tensor_leaves(
            (s.state, s.tsdf, s.atlas))])))
    eager = shell_run(EagerSLAM(cfg, K, device=cuda_device), rgb, dep, masks,
                      rewind=rewind)
    assert not eager.graphs
    assert_shell_equals_drive(slam, run_record(eager))
    assert all(p == ptrs[0] for p in ptrs)
    g = slam.graphs
    # one tracking graph, and one more for the frames that bring a mask
    assert g["track"].replays == len(rgb)
    assert len(g["track"].graphs) == (1 if masks is None else 2)
    assert g["ba"].replays == len(slam.ba_stats) > 0
    assert g["icp" if case == "every_program" else "icp_atlas"].replays > 0
    if case == "every_program":
        assert slam.reloc_events and g["reloc"].replays >= 1
        assert g["cull"].replays >= 1 and g["integrate"].replays >= 1
    else:
        # one graph each, whichever ring slot it opens or fuses
        assert g["submap_fuse"].replays >= 2
        assert len(g["submap_fuse"].graphs) == len(g["submap_start"].graphs) == 1


@pytest.mark.parametrize("submaps", [0, 2], ids=["volume", "atlas"])
def test_graphed_chunked_programs_equal_graph_false(cuda_device, submaps):
    """ChunkedStream on the card with its per-keyframe programs as CUDA
    graphs (the cull, the relocalization attempt and the volume's
    integrate, or the atlas's submap start and fuse) against the same
    stream with ``graph=False``: output rows, events, final state and
    volume or atlas bit-equal; one graph per program, captured once and
    replayed after (tests/test_torch_stream_programs.py holds the eager
    programs against a drive of the functions on the CPU)."""
    from test_torch_stream_programs import _run, _same_rows, _scene

    from kbslam_torch.device import tensor_leaves
    from kbslam_torch.streaming import ChunkedStream

    cfg, K, rgb, dep = _scene(submaps)

    def run(graph):
        cs = ChunkedStream(cfg, Intrinsics.from_matrix(K),
                           init_state(cfg, cuda_device), chunk=4, graph=graph)
        got = []
        for i in range(len(rgb)):
            got += cs.feed(rgb[i], dep[i])
        return cs, got + cs.flush()

    (cs, got), (ref, ref_got) = run(True), run(False)
    assert cs.reloc_events and ref.graphs == {}
    _same_rows(got, ref_got)
    assert cs.reloc_events == ref.reloc_events
    assert cs.loop_events == ref.loop_events
    for a, b in zip(tensor_leaves((cs.state, cs.tsdf, cs.atlas)),
                    tensor_leaves((ref.state, ref.tsdf, ref.atlas))):
        assert torch.equal(a, b)
    names = {"cull", "reloc"} | ({"integrate"} if submaps == 0 else
                                {"submap_start", "submap_fuse"})
    assert set(cs.graphs) == names
    for name, g in cs.graphs.items():
        assert len(g.graphs) == 1 and g.replays >= 1, name
    if submaps:
        assert cs.atlas.count == ref.atlas.count >= 2


def _tracked_slam(dev):
    """SLAM on the card over 20 frames of the 240x320 sequence, BA off,
    a keyframe every third frame or so."""
    seq = synthetic.render_sequence(num_frames=20, height=240, width=320)
    cfg = _cfg240().replace(policy=config.KeyframePolicyConfig(
        min_frame_gap=3, rotation_threshold_deg=2.0))
    slam = SLAM(cfg, seq.K, ba_mode="disabled", use_mask=False, device=dev)
    for i in range(20):
        slam.process(seq.rgb[i], seq.depth[i])
    assert slam.num_keyframes >= 4
    return slam


def test_run_global_ba_replays_its_captured_solve(cuda_device):
    """``SLAM.run_global_ba`` three times from the same map: the first
    call solves eagerly (the shape's first solve, no capture), the second
    captures the solve at the map's shape and replays it, the third
    replays it with no new capture, and all equal the eager solve
    (``run_global_ba_on_map(graph=False)``) bit for bit."""
    from kbslam_torch import device
    from kbslam_torch.pipeline import clone_state
    from kbslam_torch.slam import run_global_ba_on_map

    slam = _tracked_slam(cuda_device)
    saved = clone_state(slam.state)
    ref, ref_costs = run_global_ba_on_map(saved.map, slam.intr,
                                          slam.config.ba, graph=False)
    for call in range(3):
        slam.state = saved
        captures = device.captures["global_ba"]
        replays = device.replays["global_ba"]
        costs = slam.run_global_ba()
        assert costs == ref_costs
        for name in ("kf_q", "kf_t", "mp_pos"):
            assert torch.equal(getattr(slam.state.map, name),
                               getattr(ref, name)), (call, name)
        assert device.replays["global_ba"] == replays + (call > 0)
        assert device.captures["global_ba"] == captures + (call == 1)


def _nccl_graphed_rank(group):
    """One rank of an NCCL group: the synthetic global problem, camera-
    and landmark-sharded, solved by its captured graph
    (``replayed_global_solve``, the collectives inside) three times in a
    process that has run no solve before (eager, capture and replay,
    replay), then eagerly."""
    from kbslam_torch import device
    from kbslam_torch.ba import global_ba as gba

    data, intr, _ = gba.make_synthetic_global_problem(
        np.random.default_rng(0), group.device)
    res = {}
    for name, ls in (("cameras", False), ("landmarks", True)):
        shard = gba.shard_global_data(data, group)
        settings = (intr, 4, 25, False, 1.0, group, ls)
        graphed = gba.replayed_global_solve(*settings)
        before = device.captures["global_ba"]
        runs = []
        for _ in range(3):
            out, costs = graphed(shard)
            runs.append([t.cpu() for t in list(out) + [costs]])
        out, costs = gba.make_global_solve(*settings)(shard)
        res[name] = dict(eager=[t.cpu() for t in list(out) + [costs]],
                         runs=runs,
                         captures=device.captures["global_ba"] - before)
    res["group_graphs"] = len(group.graphs)
    return res


def test_nccl_group_of_one_captures_the_sharded_solve(cuda_device):
    """An NCCL group of one rank: the camera- and the landmark-sharded
    solve captured with their collectives (one capture each, kept in the
    group's ``graphs``, which ``spawn`` clears before it destroys the
    group) at their second call and replayed, every call bit-equal to the
    eager sharded solve."""
    from kbslam_torch.parallel import dist

    (res,) = dist.spawn(_nccl_graphed_rank, 1, "cuda", timeout_s=300)
    assert res.pop("group_graphs") == 2
    for name in ("cameras", "landmarks"):
        r = res[name]
        assert r["captures"] == 1, name
        for run in r["runs"]:
            assert all(torch.equal(a, b) for a, b in zip(run, r["eager"]))


def test_stage_marks_inside_the_shell_graphs(cuda_device):
    """The stage marks in the shell's CUDA graphs: the track graph holds
    a first and a last mark and the step's five; with the recorder on,
    each replay gives the four stages on the device's clock, in order and
    inside the graph's first-to-last span, and the upload between the
    shell's two marks; results and host syncs equal a run with the
    recorder off."""
    from kbslam_torch.utils import profiling

    seq = synthetic.render_sequence(num_frames=12, height=480, width=640)

    def run(on):
        slam = SLAM(config.SLAMConfig(), seq.K, device=cuda_device)
        for i in range(4):
            slam.process(seq.rgb[i], seq.depth[i])
        profiling.reset()
        if on:
            profiling.enable()
        for i in range(4, 11):
            slam.process(seq.rgb[i], seq.depth[i])
        syncs = profiling.sync_sites(
            lambda: slam.process(seq.rgb[11], seq.depth[11]))
        profiling.disable()
        return slam, syncs, profiling.records()

    off, syncs_off, none = run(False)
    on, syncs_on, recs = run(True)
    assert none == [] and syncs_on == syncs_off
    np.testing.assert_array_equal(np.stack(off.frame_poses),
                                  np.stack(on.frame_poses))
    (g,) = on.graphs["track"].graphs.values()
    assert g.graph.marks.labels == [None, None, "frontend", "match", "pnp",
                                    "map", None]
    marks = {(r["frame"], r["name"]): r for r in recs if r["kind"] == "marks"}
    stages = [r for r in recs
              if r["kind"] == "stage" and r["graph"] == "track"]
    assert [r["name"] for r in stages] == ["frontend", "match", "pnp",
                                           "map"] * 8
    for r in stages:
        m = marks[(r["frame"], "track")]
        assert r["clock"] == "device"
        assert m["start_ns"] <= r["start_ns"] < r["end_ns"] <= m["end_ns"]
    uploads = [r for r in recs
               if r["kind"] == "stage" and r["name"] == "upload"]
    assert [r["frame"] for r in uploads] == list(range(4, 12))
    for r in uploads:
        assert r["end_ns"] <= marks[(r["frame"], "track")]["start_ns"]
    per = {}
    for r in recs:
        if r["kind"] == "count" and r["name"] == "shell.syncs":
            per[r["frame"]] = per.get(r["frame"], 0) + r["n"]
    assert per[11] == sum(syncs_on.values())


ICP_DELTA = [0.025, -0.02, 0.02, 0.012, -0.015, 0.010]   # test_dense_icp.py


def _icp_inputs(dev, case):
    """tests/test_torch_icp.py's spheres fused by the port on the CPU, on
    ``dev``: ("atlas") its two-submap atlas in a ring of 4 and the
    window [1, 0, 0] (the older slot repeated, as the shells pad a short
    window) with the stored anchors, or ("volume", "volume-3cm") its
    monolithic volume at 5 cm or 3 cm voxels as a ring of one; frame 6's
    points, the start pose perturbed from the truth, and 10 trips.
    Returns the arguments of ``ops.icp.align``."""
    from kbslam_torch.config import DenseIcpConfig, DenseMapConfig
    from kbslam_torch.geom.se3 import SE3
    from kbslam_torch.mapping import dense, submap
    from kbslam_torch.mapping.icp import _frame_points

    seq = synthetic.render_sequence(num_frames=12, height=240, width=320,
                                    scene="spheres")
    intr = Intrinsics.from_matrix(seq.K)

    def qt(i):
        T = SE3.from_matrix(torch.tensor(seq.poses[i], dtype=torch.float32))
        return T.q, T.t

    def depth(i):
        return torch.from_numpy(seq.depth[i].astype(np.int32))

    if case == "atlas":
        cfg = DenseMapConfig(voxel_size=0.05, dims=(96, 96, 56),
                             origin=(-2.4, -2.4, 0.6))
        start, fuse = submap.make_submap_ops(cfg, intr, 4, 0.001)
        atlas = submap.empty_atlas(cfg, 4, "cpu")
        for a, frames in ((2, range(0, 6)), (8, range(6, 12))):
            atlas = start(atlas, *qt(a), a)
            for i in frames:
                atlas = fuse(atlas, depth(i), *qt(i), *qt(a))
        slots = torch.tensor([1, 0, 0], dtype=torch.int32)
        vols = (atlas.tsdf, atlas.weight, slots, atlas.anchor_q[slots],
                atlas.anchor_t[slots])
    else:
        # "volume-3cm": 3 cm voxels, where the float32 of the double 1 / h
        # (torch's reciprocal for x / h on the card) and 1.0f / (float)h
        # differ in the last bit
        h = 0.05 if case == "volume" else 0.03
        n = round(6.0 / h)
        cfg = DenseMapConfig(voxel_size=h, dims=(n, n, round(2.0 / h)),
                             origin=(-3.0, -3.0, -1.6))
        fuse = dense.make_integrate(cfg, intr, 0.001)
        vol = dense.empty_tsdf(cfg, "cpu")
        for i in range(12):
            vol = fuse(vol, depth(i), *qt(i))
        vols = (vol.tsdf[None], vol.weight[None],
                torch.zeros(1, dtype=torch.int32), None, None)
    p_cam, p_ok = _frame_points(depth(6).to(torch.float32) * 0.001, intr,
                                cfg, 4)
    T0 = SE3.exp(torch.tensor(ICP_DELTA)) @ SE3(*qt(6))
    args = (*vols, p_cam, p_ok, T0.q, T0.t)
    return ([None if a is None else a.contiguous().to(dev) for a in args]
            + [cfg, DenseIcpConfig(iters=10)])


@pytest.mark.parametrize("case", ["atlas", "volume", "volume-3cm"])
def test_icp_kernel_gives_the_twins_bits(cuda_device, case):
    """The ICP fetch kernel against its plain twin on the card, on the
    atlas (K = 3, a slot repeated) and the volume (K = 1, world
    coordinates; at 3 cm voxels too, where the reciprocal of the voxel
    size rounds otherwise in float32 than in double): the fetch's six
    results at the start pose, and the whole solve's five, equal to the
    bit. Bits and not a tolerance: the dense cell's refine turns a
    last-bit difference into millimetres."""
    from kbslam_torch.ops import icp as icp_ops

    args = _icp_inputs(cuda_device, case)
    vols, (q0, t0), (cfg, icp) = args[:7], args[7:9], args[9:]
    got = icp_ops.make_fetch(*vols, cfg, icp)(q0, t0)
    want = icp_ops.fetch_twin(*vols, cfg, icp)(q0, t0)
    names = ("X", "r", "g", "wv", "n", "rmse")
    for name, a, b in zip(names, got, want):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    assert 1000 < int(want[4]) < args[5].shape[0]
    got = icp_ops.align(*args)
    want = icp_ops.align_reference(*args)
    for name, a, b in zip(("q", "t", "num_valid", "rmse_init", "rmse"), got,
                          want):
        assert torch.equal(a, b), (name, a, b)
    assert float(want[4]) < float(want[3])


def test_icp_graph_replays_are_bit_identical(cuda_device):
    """The atlas solve captured in a CUDA graph: two replays give the same
    bits, and the eager call's; a profiled replay runs the fetch kernel
    iters + 1 times."""
    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.device import graph_capture
    from kbslam_torch.ops import icp as icp_ops

    args = _icp_inputs(cuda_device, "atlas")
    iters = args[-1].iters

    def solve():
        return torch.cat([r.reshape(-1).to(torch.float32)
                          for r in icp_ops.align(*args)])

    eager = solve()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        out = solve()
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(out.clone())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager) and torch.equal(out, eager)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("icp_fetch_kernel" in n for n in names) == iters + 1, names


def test_icp_eager_solve_counts_its_launches(cuda_device):
    """An eager solve counts iters + 1 launches."""
    from kbslam_torch.ops import icp as icp_ops

    args = _icp_inputs(cuda_device, "volume")
    icp_ops.reset_launches()
    icp_ops.align(*args)
    torch.cuda.synchronize()
    assert icp_ops.launches == args[-1].iters + 1
