"""The chunked stream's per-keyframe programs and the graphed global solve,
against the eager functions they are made of, on the CPU.

``streaming.ChunkedStream`` runs its cull, its relocalization attempt
and its fusion (the volume's integrate, the atlas's submap start and
fuse) as programs (``device.Programs``) on its static state: on CUDA
each a replayed CUDA graph, on the CPU the same function eagerly, with
whatever changes from call to call (the frame, the exclusion id, the
keyframe's depth, pose and id, the atlas slot, the ring rows) loaded
into static tensors first. ``DriveStream`` does that work as the stream
did before it had programs: each function called with host ints, its
new volume or atlas rebound, the ring rows copied by host index, the
frame copied up afresh; the stream must equal it exactly.
``slam.run_global_ba_on_map`` hands ``global_ba.make_global_solve``'s
function to the graph (``global_ba.replayed_global_solve``); on the CPU
it must equal ``global_ba_solve`` called directly. On the card,
tests/test_torch_cuda.py holds the graphs against ``graph=False``. This
file imports no JAX:

    python -m pytest tests/test_torch_stream_programs.py -q
"""
import numpy as np
import pytest
import torch

from kbslam_torch.ba import global_ba as gba
from kbslam_torch.device import (LiveGraphs, Programs, Replayed,
                                 tensor_leaves)
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping import dense, submap
from kbslam_torch.pipeline import assign_state, clone_state, init_state
from kbslam_torch.slam import reloc_to_host, run_global_ba_on_map
from kbslam_torch.streaming import ChunkedStream, unpack_mask_bits
from test_torch_slam_graph import every_program_cfg, lost_and_found

torch.set_num_threads(1)

H, W, CHUNK = 120, 160, 4


class DriveStream(ChunkedStream):
    """``ChunkedStream`` with its per-keyframe work done as before it had
    programs: the relocalization step called on fresh copies of the
    frame with the exclusion id as a host int, the volume and the atlas
    rebound to what ``integrate`` and the submap ops return, the submap
    opened at the host count, and the fusion poses
    (``_fusion_poses_now``) handed on as they come. The cull wrote in
    place before as now."""

    def __init__(self, cfg, intr, state, **kwargs):
        super().__init__(cfg, intr, state, **kwargs)
        d, scale = cfg.dense, cfg.map.depth_scale
        if self.atlas is not None:
            self._start, self._fuse = submap.make_submap_ops(
                d, intr, d.max_submaps, scale)
        elif self.tsdf is not None:
            self._integ = dense.make_integrate(d, intr, scale)

    def _attempt(self, arrays):
        rgb, dep = (torch.from_numpy(a).to(self.device) for a in arrays[:2])
        mask = None
        if self.use_mask:
            mask = torch.from_numpy(arrays[2]).to(self.device)
            if self._packed_mask:
                mask = unpack_mask_bits(mask, dep.shape[-1])
        st, r = self._reloc(self._state, rgb, dep, mask,
                            exclude_from_id=self._tracked_kf)
        assign_state(self._state, st)
        return reloc_to_host(r, self._state.map)

    def _fuse_kf(self, q, t, depth, kid):
        self._last_kf_view = (np.asarray(q), np.asarray(t), depth, kid)
        depth = torch.from_numpy(np.array(depth))
        q = torch.from_numpy(np.asarray(q, np.float32))
        t = torch.from_numpy(np.asarray(t, np.float32))
        if self.atlas is None:
            self.tsdf = self._integ(self.tsdf, depth, q, t)
            return
        if self._kf_insertions % self._submap_every == 0:
            self.atlas = self._start(self.atlas, q, t, kid)
            self._active_anchor_kid = kid
        self.atlas = self._fuse(self.atlas, depth,
                                *self._fusion_poses_now(kid, q, t))
        self._kf_insertions += 1


def _scene(submaps):
    """The lost-and-found frames at 160x120 (pan away, three blank
    frames, pan back) with a ring of 8 keyframes, culling, loop probes,
    relocalization after 2 failures and the volume (``submaps`` 0) or an
    atlas opening a submap every ``submaps`` insertions."""
    K, rgb, dep = lost_and_found(11, H, W)
    return every_program_cfg(H, W, submaps=submaps, icp="off"), K, rgb, dep


def _run(cls, cfg, K, rgb, dep):
    """``cls`` over the frames: (the stream, its output rows, its culls);
    the programs keep the state and the volume where they are."""
    cs = cls(cfg, Intrinsics.from_matrix(K), init_state(cfg, "cpu"),
             chunk=CHUNK)
    cull, culls = cs._cull, []
    cs._cull = lambda m: culls.append(1) or cull(m)
    ptrs = [t.data_ptr() for t in tensor_leaves((cs.state, cs.tsdf))]
    got = []
    for i in range(len(rgb)):
        got += cs.feed(rgb[i], dep[i])
        if cls is ChunkedStream:
            assert [t.data_ptr() for t in tensor_leaves(
                (cs.state, cs.tsdf))] == ptrs
    got += cs.flush()
    return cs, got, len(culls)


def _same_rows(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for k in x:
            same = (np.array_equal(x[k], y[k]) if isinstance(x[k], np.ndarray)
                    else x[k] == y[k])
            assert same, f"frame {i}: {k} {x[k]} != {y[k]}"


def _both(submaps):
    """The stream and the drive over the scene."""
    cfg, K, rgb, dep = _scene(submaps)
    return (_run(ChunkedStream, cfg, K, rgb, dep),
            _run(DriveStream, cfg, K, rgb, dep), (cfg, K, rgb, dep))


@pytest.fixture(scope="module")
def volume_runs():
    return _both(0)


@pytest.fixture(scope="module")
def atlas_runs():
    """With an atlas that opens a submap every two insertions."""
    return _both(2)


@pytest.fixture(params=["volume", "atlas"])
def runs(request):
    return request.getfixturevalue(f"{request.param}_runs")


def test_chunked_programs_equal_the_drive(runs):
    """Every output row, the relocalization and loop events, the final
    state and the volume or atlas equal the drive's exactly; the run
    culled, relocalized and fused, and the programs kept the stream's
    tensors where they were."""
    (cs, got, culls), (ref, ref_got, _), _ = runs
    assert cs.reloc_events and sum(r["added_kf"] for r in got) >= 4
    assert culls >= 4 and int(cs.state.map.num_kf) > cs.state.map.capacity_kf
    _same_rows(got, ref_got)
    assert cs.reloc_events == ref.reloc_events
    assert cs.loop_events == ref.loop_events
    for a, b in zip(tensor_leaves((cs.state, cs.tsdf, cs.atlas)),
                    tensor_leaves((ref.state, ref.tsdf, ref.atlas))):
        assert torch.equal(a, b)
    if cs.atlas is not None:
        assert cs.atlas.count == ref.atlas.count >= 2
        assert cs._kf_insertions == ref._kf_insertions
    assert cs.graphs == {}      # the CPU runs the functions themselves


def test_submap_programs_at_device_scalars_equal_the_host_ints(
        atlas_runs):
    """The stream's submap start and fuse programs read the ring slot,
    the keyframe id and the poses from static tensors (what their graphs
    replay on); called so, on copies of the final atlas, they equal
    ``start_submap`` and the fuse at the host count and host id, for
    every slot of the ring, with ``_fusion_poses_now``'s poses."""
    (cs, _, _), _, (cfg, K, _, dep) = atlas_runs
    d = cfg.dense
    start, fuse = submap.make_submap_ops(d, Intrinsics.from_matrix(K),
                                         d.max_submaps, cfg.map.depth_scale)
    depth = torch.from_numpy(dep[20].astype(np.int32))
    q = cs.state.map.kf_q[1].clone()
    t = cs.state.map.kf_t[1].clone()
    kid = cs._active_anchor_kid + 1
    i64 = dict(dtype=torch.int64)

    def copy(atlas, count):
        return atlas._replace(tsdf=atlas.tsdf.clone(),
                              weight=atlas.weight.clone(),
                              anchor_q=atlas.anchor_q.clone(),
                              anchor_t=atlas.anchor_t.clone(),
                              anchor_kf_id=atlas.anchor_kf_id.clone(),
                              count=count)

    for count in range(cs.atlas.count, cs.atlas.count + d.max_submaps):
        host = start(copy(cs.atlas, count), q, t, kid)
        dev = copy(cs.atlas, count + 1)
        cs._submap_start(dev, torch.tensor(dev.active_slot(), **i64), q, t,
                         torch.tensor(kid, dtype=torch.int32))
        poses = cs._fusion_poses_now(kid, q, t)
        host = fuse(host, depth, *poses)
        cs._submap_fuse(dev, torch.tensor(dev.active_slot(), **i64), depth,
                        *(p.clone() for p in poses))
        assert host.count == dev.count
        for a, b in zip(tensor_leaves(host), tensor_leaves(dev)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [-3, 5])
def test_reloc_program_with_a_device_exclusion_equals_the_host_int(
        runs, offset):
    """The stream's relocalization attempt (gray frame, bit-packed mask
    unpacked inside the program, the exclusion id loaded into a device
    scalar) equals the step called with the host int and the mask
    unpacked outside, in result and new state, with an id that masks
    keyframes out and one that does not."""
    from kbslam_torch.loop.reloc import (make_reloc_step, reloc_record,
                                         reloc_vector)

    (cs, _, _), _, (cfg, K, rgb, dep) = runs
    intr = Intrinsics.from_matrix(K)
    exclude = int(cs.state.map.num_kf) + offset
    mask = np.ones((H, W), np.uint8)
    mask[:, :8] = 0
    probe = ChunkedStream(cfg, intr, clone_state(cs.state), chunk=CHUNK,
                          gray=True, use_mask=True)
    arrays = probe._host_frame(rgb[27], dep[27], mask)
    probe._tracked_kf = exclude
    got = probe._attempt(arrays)
    lc = cfg.loop
    step = make_reloc_step(cfg, intr, use_mask=True, word_bits=lc.word_bits,
                           score_min=lc.reloc_score_min,
                           min_inliers=lc.reloc_min_inliers)
    new, r = step(clone_state(cs.state), torch.from_numpy(arrays[0]),
                  torch.from_numpy(arrays[1]),
                  torch.from_numpy(np.unpackbits(arrays[2], axis=-1)[:, :W]),
                  exclude_from_id=exclude)
    want = reloc_record(reloc_vector(r, new.map).numpy())
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    for a, b in zip(tensor_leaves(probe.state), tensor_leaves(new)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth_rows", [False, True])
def test_the_graphed_solve_function_equals_global_ba_solve(depth_rows):
    """The function ``run_global_ba_on_map`` hands to the graph
    (``make_global_solve``), called on static inputs loaded with the
    problem as ``CapturedCall.load`` loads them, equals ``global_ba_solve``
    called directly, bit for bit."""
    data, intr, _ = gba.make_synthetic_global_problem(
        np.random.default_rng(1), "cpu")
    data = data._replace(
        z_meas=torch.where(data.active, 3.0, 0.0),
        w_d=torch.where(data.active, 4.0, 0.0))
    solve = gba.make_global_solve(intr, 3, 8, depth_rows, 0.5)
    static = gba.GlobalBAData(*(torch.empty_like(x) for x in data))
    for dst, src in zip(tensor_leaves(static), tensor_leaves(data)):
        dst.copy_(src)
    got, costs = solve(static)
    ref, ref_costs = gba.global_ba_solve(data, intr, iters=3, pcg_iters=8,
                                         depth_rows=depth_rows,
                                         huber_delta=0.5)
    assert torch.equal(costs, ref_costs)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_run_global_ba_on_map_equals_its_eager_pieces(runs):
    """``run_global_ba_on_map`` on the CPU (and with ``graph=False``)
    equals the problem built from the map, solved by ``global_ba_solve``
    and written back."""
    (cs, _, _), _, (cfg, K, _, _) = runs
    intr = Intrinsics.from_matrix(K)
    m = cs.state.map
    got, costs = run_global_ba_on_map(m, intr, cfg.ba, steps=2, pcg_iters=6)
    again, costs2 = run_global_ba_on_map(m, intr, cfg.ba, steps=2,
                                         pcg_iters=6, graph=False)
    n = min(int(m.num_kf), m.capacity_kf)
    data, slots, real = gba.from_map_state(m, intr, cfg.ba, n)
    out, ref_costs = gba.global_ba_solve(
        data, intr, iters=2, pcg_iters=6, depth_rows=cfg.ba.depth_residuals,
        huber_delta=cfg.ba.huber_delta)
    ref = gba.write_back(m, out, slots, real)
    assert costs == costs2 == [float(c) for c in ref_costs.numpy()]
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_graphed_wrappers_raise_on_cpu_tensors():
    """A graphed program given CPU tensors raises; ``Programs`` on the
    CPU (or with ``graphed=False``) hands back the function itself."""
    x = torch.zeros(3)
    with pytest.raises(ValueError):
        LiveGraphs(lambda a: a)(x)
    with pytest.raises(ValueError):
        Replayed(lambda a: a, "identity")(x)
    data, intr, _ = gba.make_synthetic_global_problem(
        np.random.default_rng(0), "cpu")
    with pytest.raises(ValueError):
        gba.replayed_global_solve(intr, 2, 3, False, 1.0)(data)
    for programs in (Programs(torch.device("cpu")),
                     Programs(torch.device("cpu"), graphed=False)):
        def fn(a):
            return a
        assert programs.program("fn", fn) is fn and programs.graphs == {}
        assert not programs.graphed
        buf = programs.load("v", np.arange(3), torch.int64)
        assert programs.load("v", np.arange(3) + 1, torch.int64) is buf
        assert buf.tolist() == [1, 2, 3]
