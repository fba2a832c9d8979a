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
