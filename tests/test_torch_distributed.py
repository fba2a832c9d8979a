"""The port's multi-device paths (kbslam_torch/parallel/dist.py and the
``group`` of global BA, multistream tracking and dense fusion) against
the reference's sharded programs, over gloo on the CPU at 2 and 4 ranks.

Each world runs once, in ``spawn``'s processes (``_world_rank``; the
world-2 run also solves the tracked map, tracks the streams and runs the
dryrun), and returns host arrays; the tests hold them against JAX on
``make_mesh(W)`` (tests/conftest.py gives 8 CPU devices) and the port on
one device.
JAX is imported only in the parent's test bodies: a spawned rank imports
this module by name and must load neither ``jax`` nor ``kbslam``.

Bounds, those of the reference's multi-device tests:
- camera-sharded ``global_ba_step`` (tests/test_global_ba.py:
  test_global_ba_matches_single_device): the cost within 1e-3 relative,
  ``cam_t`` and ``mp_pos`` within 1e-4, against JAX on the mesh and the
  port on one device; the gauge camera bit-unchanged
  (test_gauge_fixed_camera_unchanged);
- camera-sharded and landmark-sharded ``global_ba_solve``
  (test_landmark_sharded_solve_matches_replicated): landmark-sharded
  against camera-sharded costs rtol 1e-4, positions 1e-4; against one
  device (the port's, and JAX's on the mesh for the camera-sharded
  solve) costs rtol 1e-2 atol 1e-6, positions 1e-4; monotone costs and
  live PCG trips; PCG's early stop (test_pcg_early_stop_bounds_iterations);
- ``run_global_ba_on_map`` at W = 2 on JAX's tracked map against JAX's
  with ``mesh=make_mesh(2)``: the bounds of
  tests/test_torch_global_ba.py::test_run_global_ba_on_map_matches_reference;
- 4 streams over 2 ranks: every stream's outputs and state bit-equal to
  the port's unsharded step and scan, with the gates of
  tests/test_parallel.py::test_multistream_tracks_independent_streams;
- slab fusion at dims (48, 24, 16) (test_sharded_dense_fusion_matches_
  single_device): gathered, bit-equal to the port's unsharded
  ``integrate``, with 0 collectives; against JAX's
  ``make_sharded_integrate`` the bound of tests/test_torch_dense.py
  (weights equal and tsdf within 1e-6 away from a .5 rounding edge);
- indivisible C, P, S and nx raise ``ValueError`` on every rank before
  any collective; the dryrun of __graft_entry__.py:78-128 at W = 2.
"""
import sys
import time

import numpy as np
import pytest
import torch

from kbslam_torch.ba import global_ba as tgba
from kbslam_torch.config import DenseMapConfig, tiny_config
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.io.synthetic import render_sequence
from kbslam_torch.mapping import dense as tdense
from kbslam_torch.parallel import dist as tdist
from kbslam_torch.parallel.multistream import (batched_init_state,
                                               gather_streams,
                                               make_multistream_scan,
                                               make_multistream_step,
                                               shard_streams)

torch.set_num_threads(1)
WORLDS = (2, 4)
TIMEOUT_S = 240.0
STREAMS, STREAM_FRAMES, H, W_IMG = 4, 4, 120, 160
FUSE_DIMS = (48, 24, 16)


def _problem(seed, n_cams=8, n_pts=64):
    return tgba.make_synthetic_global_problem(np.random.default_rng(seed),
                                              "cpu", n_cams=n_cams,
                                              n_pts=n_pts)


def _fuse_cfg(dims=FUSE_DIMS):
    return DenseMapConfig(dims=dims, voxel_size=0.17,
                          origin=(-4.08, -2.04, -1.36))


def _host(tree):
    """A (nested) NamedTuple of tensors as a dict of numpy arrays."""
    return {k: (_host(v) if isinstance(v, tuple) else v.cpu().numpy())
            for k, v in tree._asdict().items()}


def _counts(group):
    return {op: list(c) for op, c in group.counts.items()}


# --- what each rank runs (module level: spawn pickles it by name) ------------

def _global_ba_rank(group):
    out = {}
    data, intr, _ = _problem(1, n_pts=48)
    group.reset_counts()
    d, cost = tgba.global_ba_step(tgba.shard_global_data(data, group), intr,
                                  pcg_iters=15, group=group)
    out["step_counts"] = _counts(group)
    d = tgba.gather_global_data(d, group)
    out["step"] = dict(cost=float(cost), cam_t=d.cam_t.numpy(),
                       mp_pos=d.mp_pos.numpy())
    for name, ls in (("solve", False), ("solve_ls", True)):
        data, intr, _ = _problem(3, n_pts=48)
        group.reset_counts()
        d, costs, stats = tgba.global_ba_solve(
            tgba.shard_global_data(data, group), intr, iters=3, pcg_iters=25,
            return_stats=True, group=group, landmark_sharded=ls)
        out[name + "_counts"] = _counts(group)
        d = tgba.gather_global_data(d, group)
        out[name] = dict(costs=costs.numpy(), cam_t=d.cam_t.numpy(),
                         mp_pos=d.mp_pos.numpy(), stats=_host(stats))
    data, intr, _ = _problem(2)
    d, _ = tgba.global_ba_step(tgba.shard_global_data(data, group), intr,
                               pcg_iters=10, group=group)
    d = tgba.gather_global_data(d, group)
    out["gauge"] = dict(q=d.cam_q[0].numpy(), t=d.cam_t[0].numpy())
    if group.world == 4:
        data, intr, _ = _problem(4, n_pts=48)
        _, costs, stats = tgba.global_ba_solve(
            tgba.shard_global_data(data, group), intr, iters=4,
            pcg_iters=100, pcg_tol=1e-2, return_stats=True, group=group)
        out["early"] = dict(costs=costs.numpy(), stats=_host(stats))
    return out


def _fusion_rank(group, depths, poses_qt):
    cfg = _fuse_cfg()
    intr = TIntr.from_matrix(depths["K"])
    fuse = tdense.make_sharded_integrate(cfg, intr, group, depth_scale=0.001)
    slab = tdense.shard_tsdf(tdense.empty_tsdf(cfg, "cpu"), group)
    group.reset_counts()
    for d, (q, t) in zip(depths["depth"], poses_qt):
        slab = fuse(slab, torch.from_numpy(d), torch.from_numpy(q),
                    torch.from_numpy(t))
    counts = _counts(group)
    vol = tdense.gather_tsdf(slab, group)
    return dict(counts=counts, slab_shape=tuple(slab.tsdf.shape),
                tsdf=vol.tsdf.numpy(), weight=vol.weight.numpy())


def _indivisible_rank(group):
    """Sizes one past a multiple of W, each of which must raise
    ``ValueError`` on this rank before any collective."""
    Wn = group.world
    cases = {}

    def expect(name, fn):
        group.reset_counts()
        try:
            fn()
        except ValueError as e:
            cases[name] = ("ValueError", str(e), group.collectives())
        else:
            cases[name] = ("no error", "", group.collectives())

    data, intr, _ = _problem(0, n_cams=2 * Wn + 1)
    expect("cameras", lambda: tgba.shard_global_data(data, group))
    data, intr, _ = _problem(0, n_cams=2 * Wn, n_pts=8 * Wn + 1)  # P = n + 16
    expect("landmarks", lambda: tgba.global_ba_solve(
        tgba.shard_global_data(data, group), intr, iters=1, pcg_iters=2,
        group=group, landmark_sharded=True))
    cfg = tiny_config(height=H, width=W_IMG)
    tintr = TIntr.create(130.0, 130.0, 80.0, 60.0)
    S = 2 * Wn + 1
    expect("streams", lambda: shard_streams(
        batched_init_state(cfg, S, "cpu"), group))
    expect("stream step", lambda: make_multistream_step(cfg, tintr, S,
                                                        group=group))
    expect("stream scan", lambda: make_multistream_scan(cfg, tintr, S,
                                                        group=group))
    bad = _fuse_cfg((4 * Wn + 1, 8, 8))
    expect("voxels", lambda: tdense.shard_tsdf(tdense.empty_tsdf(bad, "cpu"),
                                               group))
    expect("sharded integrate", lambda: tdense.make_sharded_integrate(
        bad, tintr, group))
    return cases


def _loaded_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "kbslam") or m.startswith(("jax.",
                                                             "kbslam.")))


def _world_rank(group, inputs):
    out = dict(rank=group.rank, world=group.world,
               global_ba=_global_ba_rank(group),
               fusion=_fusion_rank(group, inputs["depths"], inputs["poses"]),
               indivisible=_indivisible_rank(group))
    if "map" in inputs:
        out["map"] = _map_rank(group, *inputs["map"])
        out["streams"] = _streams_rank(group, *inputs["streams"])
        out["dryrun"] = _dryrun_rank(group)
    out["modules"] = _loaded_modules()
    return out


def _streams_rank(group, rgb, depth):
    """4 streams over the ranks: the immediate step for the frames, then
    the deferred scan over the same frames from a fresh state."""
    cfg = tiny_config(height=H, width=W_IMG)
    intr = TIntr.create(130.0, 130.0, (W_IMG - 1) / 2, (H - 1) / 2)
    rgb, depth = torch.from_numpy(rgb), torch.from_numpy(depth)
    step = make_multistream_step(cfg, intr, STREAMS, group=group)
    state = shard_streams(batched_init_state(cfg, STREAMS, "cpu"), group)
    group.reset_counts()
    outs = []
    for t in range(rgb.shape[0]):
        state, o = step(state, shard_streams(rgb[t], group),
                        shard_streams(depth[t], group))
        outs.append(o)
    scan = make_multistream_scan(cfg, intr, STREAMS, apply_every=4,
                                 group=group)
    st_d, ninl = scan(shard_streams(batched_init_state(cfg, STREAMS, "cpu"),
                                    group),
                      shard_streams(rgb.movedim(1, 0), group).movedim(0, 1),
                      shard_streams(depth.movedim(1, 0), group).movedim(0, 1))
    counts = _counts(group)
    return dict(counts=counts, local=int(state.map.num_kf.shape[0]),
                outs=[_host(gather_streams(o, group)) for o in outs],
                state=_host(gather_streams(state, group)),
                scan_state=_host(gather_streams(st_d, group)),
                scan_ninl=gather_streams(ninl.movedim(1, 0), group)
                .movedim(0, 1).numpy())


def _map_rank(group, map_np, K, ba_cfg):
    from kbslam_torch import convert
    from kbslam_torch.slam import run_global_ba_on_map

    new, costs = run_global_ba_on_map(convert.map_to_torch(map_np, "cpu"),
                                      TIntr.from_matrix(K), ba_cfg,
                                      group=group)
    return dict(costs=costs, map=_host(new))


def _dryrun_rank(group):
    """__graft_entry__.py:78-128 on the port: S = W streams tracked one
    step over the ranks, a local BA of each stream's map, the sharded
    global BA dryrun and one voxel-slab fusion."""
    from kbslam_torch.ba.local_ba import local_ba
    from kbslam_torch.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig
    from kbslam_torch.parallel.multistream import stream_state

    cfg = SLAMConfig(image_height=120, image_width=160,
                     orb=OrbConfig(num_features=128, num_levels=2,
                                   max_features=128),
                     pnp=PnPConfig(num_hypotheses=32, refine_iters=3),
                     map=MapConfig(max_keyframes=8, max_map_points=1024))
    intr = TIntr.create(130.0, 130.0, 80.0, 60.0)
    S = group.world
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.integers(0, 255, size=(S, 120, 160, 3),
                                        dtype=np.uint8))
    depth = torch.from_numpy(rng.integers(500, 3000, size=(S, 120, 160),
                                          dtype=np.uint16).astype(np.int32))
    step = make_multistream_step(cfg, intr, S, group=group)
    states, outs = step(shard_streams(batched_init_state(cfg, S, "cpu"),
                                      group),
                        shard_streams(rgb, group), shard_streams(depth, group))
    for i in range(states.map.num_kf.shape[0]):
        m, _ = local_ba(stream_state(states, i).map, intr, cfg.ba)
        assert torch.isfinite(m.kf_t).all() and torch.isfinite(m.mp_pos).all()
    tgba.dryrun_sharded_global_ba(group)
    dcfg = DenseMapConfig(dims=(2 * group.world, 8, 8), voxel_size=0.17,
                          origin=(-1.0, -0.68, 0.2))
    fuse = tdense.make_sharded_integrate(dcfg, intr, group, depth_scale=0.001)
    vol = fuse(tdense.shard_tsdf(tdense.empty_tsdf(dcfg, "cpu"), group),
               depth[0], torch.tensor([1.0, 0, 0, 0]), torch.zeros(3))
    return dict(added=gather_streams(outs.added_kf, group).tolist(),
                slab=tuple(vol.tsdf.shape),
                fused=bool(torch.isfinite(vol.tsdf).all()),
                modules=_loaded_modules())


def _raise_rank(group):
    return shard_streams(torch.zeros(3), group)


def _hang_rank(group):
    if group.rank == 0:
        group.sum(torch.ones(3))
    else:
        time.sleep(120)


# --- inputs and runs (the parent) --------------------------------------------

def _make_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), axis_names=("stream",))


def _place(data, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kbslam.ba.global_ba import GlobalBAData

    shard, rep = NamedSharding(mesh, P("stream")), NamedSharding(mesh, P())
    return GlobalBAData(*[jax.device_put(np.asarray(x), shard)
                          for x in data[:9]],
                        jax.device_put(np.asarray(data.mp_pos), rep),
                        jax.device_put(np.asarray(data.anchor_mp), rep))


@pytest.fixture(scope="module")
def fusion_inputs():
    """tests/test_parallel.py's fusion inputs: 3 frames of 120x160 and
    their poses as JAX's ``SE3.from_matrix`` gives them."""
    import jax.numpy as jnp

    from kbslam.geom.se3 import SE3 as JSE3

    seq = render_sequence(num_frames=3, height=120, width=160)
    poses = []
    for i in range(3):
        T = JSE3.from_matrix(jnp.asarray(seq.poses[i], jnp.float32))
        poses.append((np.array(T.q), np.array(T.t)))
    return dict(depths=dict(depth=seq.depth.astype(np.int32), K=seq.K),
                poses=poses, raw_depth=seq.depth)


@pytest.fixture(scope="module")
def tracked():
    """tests/test_torch_global_ba.py's map: 24 frames tracked by JAX's
    SLAM at 240x320."""
    import jax

    from kbslam.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig
    from kbslam.io.synthetic import render_sequence as jrender
    from kbslam.slam import SLAM as JSLAM

    seq = jrender(num_frames=24, height=240, width=320)
    cfg = SLAMConfig(
        image_height=240, image_width=320,
        orb=OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=PnPConfig(num_hypotheses=128),
        map=MapConfig(max_keyframes=16, max_map_points=8192))
    slam = JSLAM(cfg, seq.K, ba_mode="disabled", use_mask=False)
    for i in range(24):
        slam.process(seq.rgb[i], seq.depth[i])
    assert int(slam.state.map.num_kf) >= 3
    return dict(cfg=cfg, jmap=slam.state.map, jintr=slam.intr, K=seq.K,
                jmap_np=jax.device_get(slam.state.map))


@pytest.fixture(scope="module")
def stream_frames():
    seqs = [render_sequence(num_frames=STREAM_FRAMES, height=H, width=W_IMG,
                            fx=130.0, seed=s) for s in range(STREAMS)]
    rgb = np.stack([np.stack([s.rgb[t] for s in seqs])
                    for t in range(STREAM_FRAMES)])
    dep = np.stack([np.stack([s.depth[t] for s in seqs])
                    for t in range(STREAM_FRAMES)]).astype(np.int32)
    return rgb, dep


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, fusion_inputs, tracked, stream_frames):
    """``spawned(W)``: the ranks' results of ``_world_rank`` at world W,
    run once per module."""
    from kbslam_torch import config as tconfig
    from kbslam_torch import convert

    runs = {}

    def get(W):
        if W not in runs:
            inputs = dict(depths=fusion_inputs["depths"],
                          poses=fusion_inputs["poses"])
            if W == 2:
                # the port's copy of the configuration: a rank must not
                # load kbslam to unpickle JAX's
                ba = tconfig.BAConfig()
                assert repr(ba) == repr(tracked["cfg"].ba)
                tmap = convert.map_to_torch(tracked["jmap_np"], "cpu")
                inputs.update(map=(convert.map_to_numpy(tmap), tracked["K"],
                                   ba), streams=stream_frames)
            runs[W] = tdist.spawn(
                _world_rank, W, "cpu", (inputs,), timeout_s=TIMEOUT_S,
                workdir=str(tmp_path_factory.mktemp(f"group{W}")))
        return runs[W]
    return get


@pytest.fixture(params=WORLDS, ids=lambda w: f"W{w}")
def world(request, spawned):
    return dict(W=request.param, runs=spawned(request.param))


def _one_device_step():
    data, intr, _ = _problem(1, n_pts=48)
    return tgba.global_ba_step(data, intr, pcg_iters=15)


def test_every_rank_ran_and_returned(world):
    assert [r["rank"] for r in world["runs"]] == list(range(world["W"]))
    assert all(r["world"] == world["W"] for r in world["runs"])


def test_camera_sharded_step_matches_jax_and_one_device(world):
    from kbslam.ba import global_ba as jgba

    W = world["W"]
    d1, c1 = _one_device_step()
    jdata, jintr, _ = jgba.make_synthetic_global_problem(
        np.random.default_rng(1), n_cams=8, n_pts=48)
    mesh = _make_mesh(W)
    jd, jc = jgba.global_ba_step(_place(jdata, mesh), jintr, mesh,
                                 pcg_iters=15)
    for r in world["runs"]:
        got = r["global_ba"]["step"]
        for cost, cam_t, mp_pos in ((float(c1), d1.cam_t.numpy(),
                                     d1.mp_pos.numpy()),
                                    (float(jc), np.asarray(jd.cam_t),
                                     np.asarray(jd.mp_pos))):
            assert abs(got["cost"] - cost) < 1e-3 * max(cost, 1.0)
            np.testing.assert_allclose(got["cam_t"], cam_t, atol=1e-4)
            np.testing.assert_allclose(got["mp_pos"], mp_pos, atol=1e-4)
    # every rank ends with the same landmarks
    for r in world["runs"][1:]:
        np.testing.assert_array_equal(r["global_ba"]["step"]["mp_pos"],
                                      world["runs"][0]["global_ba"]["step"]
                                      ["mp_pos"])
    # the step's collectives: all-reduces of the landmark sums, of the
    # cost and of PCG's dot products, and nothing else
    counts = world["runs"][0]["global_ba"]["step_counts"]
    assert counts["all_reduce"][0] == 1 + 1 + 1 + 15 * 3 + 1
    assert counts["reduce_scatter"] == [0, 0] == counts["all_gather"]


def test_camera_sharded_solve_matches_jax_and_one_device(world):
    from kbslam.ba import global_ba as jgba

    W = world["W"]
    data, intr, _ = _problem(3, n_pts=48)
    d1, c1 = tgba.global_ba_solve(data, intr, iters=3, pcg_iters=25)
    jdata, jintr, _ = jgba.make_synthetic_global_problem(
        np.random.default_rng(3), n_cams=8, n_pts=48)
    mesh = _make_mesh(W)
    jd, jc = jgba.global_ba_solve(_place(jdata, mesh), jintr, mesh, iters=3,
                                  pcg_iters=25)
    got = world["runs"][0]["global_ba"]["solve"]
    for costs, cam_t, mp_pos in ((c1.numpy(), d1.cam_t.numpy(),
                                  d1.mp_pos.numpy()),
                                 (np.asarray(jc), np.asarray(jd.cam_t),
                                  np.asarray(jd.mp_pos))):
        np.testing.assert_allclose(got["costs"], costs, rtol=1e-2, atol=1e-6)
        np.testing.assert_allclose(got["cam_t"], cam_t, atol=1e-4)
        np.testing.assert_allclose(got["mp_pos"], mp_pos, atol=1e-4)
    assert (np.diff(got["costs"]) <= 0).all()


def test_landmark_sharded_solve_matches_replicated(world):
    data, intr, _ = _problem(3, n_pts=48)
    d1, c1 = tgba.global_ba_solve(data, intr, iters=3, pcg_iters=25)
    for r in world["runs"]:
        rep, shd = r["global_ba"]["solve"], r["global_ba"]["solve_ls"]
        np.testing.assert_allclose(shd["costs"], rep["costs"], rtol=1e-4)
        np.testing.assert_allclose(shd["costs"], c1.numpy(), rtol=1e-2,
                                   atol=1e-6)
        np.testing.assert_allclose(shd["cam_t"], rep["cam_t"], atol=1e-4)
        np.testing.assert_allclose(shd["mp_pos"], rep["mp_pos"], atol=1e-4)
        np.testing.assert_allclose(shd["cam_t"], d1.cam_t.numpy(), atol=1e-4)
        assert (np.diff(rep["costs"]) <= 0).all()
        assert rep["stats"]["pcg_iters"][0] > 0
        assert shd["stats"]["pcg_iters"][0] > 0
    # the landmark sums travel as reduce-scatters and all-gathers
    P = 64
    ls = world["runs"][0]["global_ba"]["solve_ls_counts"]
    assert ls["reduce_scatter"][0] > 0 and ls["all_gather"][0] > 0
    assert ls["reduce_scatter"][1] % (P * 4) == 0
    assert world["runs"][0]["global_ba"]["solve_counts"]["reduce_scatter"] \
        == [0, 0]


def test_gauge_camera_bit_unchanged(world):
    data, _, _ = _problem(2)
    for r in world["runs"]:
        g = r["global_ba"]["gauge"]
        np.testing.assert_array_equal(g["q"], data.cam_q[0].numpy())
        np.testing.assert_array_equal(g["t"], data.cam_t[0].numpy())


def test_pcg_stops_early_on_four_ranks(spawned):
    got = spawned(4)[0]["global_ba"]["early"]
    used = got["stats"]["pcg_iters"]
    rets = got["stats"]["retries"]
    assert (used <= 100 * rets).all()
    assert used[0] < 100, used
    assert got["costs"][-1] < 1e-2 * got["costs"][0]


def test_slab_fusion_is_bit_equal_and_makes_no_collective(world,
                                                          fusion_inputs):
    import jax
    from jax.sharding import Mesh

    from kbslam.config import DenseMapConfig as JDenseMapConfig
    from kbslam.geom.camera import Intrinsics as JIntr
    from kbslam.mapping import dense as jdense
    from test_torch_dense import assert_volume_close

    W = world["W"]
    cfg = _fuse_cfg()
    seq_K = fusion_inputs["depths"]["K"]
    tintr = TIntr.from_matrix(seq_K)
    fuse1 = tdense.make_integrate(cfg, tintr, depth_scale=0.001)
    ref = tdense.empty_tsdf(cfg, "cpu")
    for d, (q, t) in zip(fusion_inputs["depths"]["depth"],
                         fusion_inputs["poses"]):
        ref = fuse1(ref, torch.from_numpy(d), torch.from_numpy(q),
                    torch.from_numpy(t))
    assert (ref.weight > 0).sum() > 100   # fused something
    for r in world["runs"]:
        got = r["fusion"]
        assert got["slab_shape"] == (FUSE_DIMS[0] // W,) + FUSE_DIMS[1:]
        assert got["counts"] == {op: [0, 0] for op in tdist.COLLECTIVES}
        np.testing.assert_array_equal(got["tsdf"], ref.tsdf.numpy())
        np.testing.assert_array_equal(got["weight"], ref.weight.numpy())

    # JAX's sharded program over a mesh of W devices
    mesh = Mesh(np.array(jax.devices()[:W]), axis_names=("vox",))
    jintr = JIntr.from_matrix(seq_K)
    jcfg = JDenseMapConfig(dims=FUSE_DIMS, voxel_size=0.17,
                                 origin=(-4.08, -2.04, -1.36))
    fuse8 = jdense.make_sharded_integrate(jcfg, jintr, mesh, depth_scale=0.001)
    js = jdense.shard_tsdf(jdense.empty_tsdf(jcfg), mesh)
    for d, (q, t) in zip(fusion_inputs["raw_depth"], fusion_inputs["poses"]):
        js = fuse8(js, d, q, t)
    got = world["runs"][0]["fusion"]
    assert_volume_close(tdense.TSDFState(torch.from_numpy(got["tsdf"]),
                                         torch.from_numpy(got["weight"])),
                        jax.device_get(js), cfg, tintr,
                        fusion_inputs["poses"])


def test_indivisible_sizes_raise_before_any_collective(world):
    names = ("cameras", "landmarks", "streams", "stream step", "stream scan",
             "voxels", "sharded integrate")
    for r in world["runs"]:
        cases = r["indivisible"]
        assert sorted(cases) == sorted(names)
        for name in names:
            kind, msg, collectives = cases[name]
            assert kind == "ValueError", (name, kind)
            assert "divisible" in msg, (name, msg)
            assert collectives == 0, (name, collectives)


def test_spawned_ranks_load_no_jax(world):
    for r in world["runs"]:
        assert r["modules"] == [], r["modules"]


# --- world 2 only --------------------------------------------------------------

def test_run_global_ba_on_map_matches_jax_on_two_devices(tracked, spawned):
    from kbslam.slam import run_global_ba_on_map as j_run
    from kbslam_torch import convert

    tmap = convert.map_to_torch(tracked["jmap_np"], "cpu")
    jnew, jcosts = j_run(tracked["jmap"], tracked["jintr"], tracked["cfg"].ba,
                         mesh=_make_mesh(2))
    runs = [r["map"] for r in spawned(2)]
    for r in runs:
        np.testing.assert_allclose(r["costs"], jcosts, rtol=1e-4)
        assert r["costs"][-1] <= r["costs"][0]
        for name in ("kf_t", "mp_pos"):
            np.testing.assert_allclose(r["map"][name],
                                       np.asarray(getattr(jnew, name)),
                                       atol=1e-5)
        for name in ("kf_id", "kf_mp", "num_kf", "num_mp"):
            np.testing.assert_array_equal(r["map"][name],
                                          getattr(tmap, name).numpy())
    for name, a in runs[1]["map"].items():
        np.testing.assert_array_equal(a, runs[0]["map"][name], err_msg=name)


def _leaves(tree):
    out = []
    for k, v in tree.items():
        out += _leaves(v) if isinstance(v, dict) else [(k, v)]
    return out


def test_sharded_streams_equal_the_unsharded_step(stream_frames, spawned):
    """4 streams over 2 ranks, each stream's outputs and state bit-equal
    to the port's unsharded step (the same global draws), with the gates
    of tests/test_parallel.py:15-47; tracking makes no collective."""
    cfg = tiny_config(height=H, width=W_IMG)
    intr = TIntr.create(130.0, 130.0, (W_IMG - 1) / 2, (H - 1) / 2)
    rgb, dep = stream_frames
    step = make_multistream_step(cfg, intr, STREAMS)
    state, outs = batched_init_state(cfg, STREAMS, "cpu"), []
    for t in range(STREAM_FRAMES):
        state, o = step(state, torch.from_numpy(rgb[t]),
                        torch.from_numpy(dep[t]))
        outs.append(_host(o))
    runs = [r["streams"] for r in spawned(2)]
    for r in runs:
        assert r["local"] == STREAMS // 2
        assert r["counts"] == {op: [0, 0] for op in tdist.COLLECTIVES}
        for t in range(STREAM_FRAMES):
            for (k, a), (_, b) in zip(_leaves(r["outs"][t]),
                                      _leaves(outs[t])):
                np.testing.assert_array_equal(a, b, err_msg=f"{t} {k}")
        for (k, a), (_, b) in zip(_leaves(r["state"]),
                                  _leaves(_host(state))):
            np.testing.assert_array_equal(a, b, err_msg=k)
    got = runs[0]
    num_kf = got["state"]["map"]["num_kf"]
    assert num_kf.shape == (STREAMS,) and (num_kf >= 1).all()
    assert got["outs"][0]["added_kf"].all()
    assert len(set(int(x) for x in got["outs"][-1]["num_matches"])) > 1


def test_sharded_scan_equals_the_unsharded_scan(stream_frames, spawned):
    cfg = tiny_config(height=H, width=W_IMG)
    intr = TIntr.create(130.0, 130.0, (W_IMG - 1) / 2, (H - 1) / 2)
    rgb, dep = stream_frames
    scan = make_multistream_scan(cfg, intr, STREAMS, apply_every=4)
    st, ninl = scan(batched_init_state(cfg, STREAMS, "cpu"),
                    torch.from_numpy(rgb), torch.from_numpy(dep))
    for r in spawned(2):
        got = r["streams"]
        np.testing.assert_array_equal(got["scan_ninl"], ninl.numpy())
        for (k, a), (_, b) in zip(_leaves(got["scan_state"]),
                                  _leaves(_host(st))):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_dryrun_multichip_contract(spawned):
    for r in spawned(2):
        got = r["dryrun"]
        assert got["added"] == [True, True]
        assert got["slab"] == (2, 8, 8) and got["fused"]


# --- the process plumbing ------------------------------------------------------

def test_a_rank_exception_is_raised_in_the_caller(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        tdist.spawn(_raise_rank, 2, "cpu", timeout_s=TIMEOUT_S,
                    workdir=str(tmp_path))


def test_a_hung_collective_fails_by_timeout(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        tdist.spawn(_hang_rank, 2, "cpu", timeout_s=6.0,
                    workdir=str(tmp_path))
    assert time.perf_counter() - t0 < 60


def test_a_cuda_group_needs_a_card_per_rank(monkeypatch):
    """NCCL or nothing: no CUDA group without cards, no gloo on CUDA."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tdist.spawn(_raise_rank, 2, "cuda")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tdist.init_group("cuda", 0, 1, store=None)
    with pytest.raises(ValueError):
        tdist.spawn(_raise_rank, 2, "meta")


def test_one_device_group_none_is_the_identity():
    """``group=None`` runs today's code: one rank's collectives are the
    identity, so a world of one in-process equals it to the bit."""
    data, intr, _ = _problem(3, n_pts=48)
    a = tgba.global_ba_solve(data, intr, iters=2, pcg_iters=10)
    b = tgba.global_ba_solve(data, intr, iters=2, pcg_iters=10, group=None,
                             landmark_sharded=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].mp_pos, b[0].mp_pos)
