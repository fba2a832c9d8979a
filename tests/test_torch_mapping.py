"""Exact parity of the port's map state and keyframe policy with the JAX
reference: ring indices, landmark ids, liveness and masked writes are
integer/selection logic, so every field must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import KeyframePolicyConfig, MapConfig, OrbConfig
from kbslam.frontend.orb import Features as JFeatures
from kbslam.geom.se3 import SE3 as JSE3
from kbslam.mapping import policy as jpolicy
from kbslam.mapping import state as jstate
from kbslam.matching.hamming import MatchResult as JMatch
from kbslam_torch import convert
from kbslam_torch.frontend.orb import Features as TFeatures
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.mapping import policy as tpolicy
from kbslam_torch.mapping import state as tstate
from kbslam_torch.matching.hamming import MatchResult as TMatch

torch.set_num_threads(1)
F = 96
MAP = MapConfig(max_keyframes=8, max_map_points=64)
ORB = OrbConfig(max_features=F)
INTR = (300.0, 310.0, 60.0, 45.0)


def _assert_maps_equal(mt, mj):
    mj = jax.device_get(mj)
    for name in tstate.MapState._fields:
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      np.asarray(getattr(mj, name)),
                                      err_msg=name)


def _frame(rng):
    xy = (rng.random((F, 2)) * [120, 90]).astype(np.float32)
    depth = np.where(rng.random(F) < 0.15, 0.0,
                     1 + rng.random(F) * 3).astype(np.float32)
    desc = (rng.random((F, 256)) > 0.5).astype(np.uint8)
    valid = rng.random(F) > 0.1
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.standard_normal(3).astype(np.float32)
    return xy, depth, desc, valid, q, t


def _match(rng, dup_targets=False):
    best = rng.integers(0, F, F).astype(np.int32)
    if dup_targets:
        # several previous-keyframe keypoints matched to ONE current one
        best[::3] = best[0]
        best[1::7] = 5
    is_match = rng.random(F) < 0.6
    z = np.zeros(F, np.int32)
    return best, is_match, z


def _run(steps, seed, dup_targets):
    """Drive both implementations through the same insert/fuse sequence,
    with ``do`` masks (some frames insert nothing), comparing every field
    after every step."""
    rng = np.random.default_rng(seed)
    mj = jstate.empty_map(MAP, ORB)
    mt = tstate.empty_map(MAP, ORB, "cpu")
    for i in range(steps):
        xy, depth, desc, valid, q, t = _frame(rng)
        best, is_match, z = _match(rng, dup_targets)
        do = bool(rng.random() < 0.8) or i == 0
        jf = JFeatures(xy=jnp.asarray(xy), response=jnp.zeros(F),
                       angle=jnp.zeros(F), level=jnp.zeros(F, jnp.int32),
                       valid=jnp.asarray(valid), desc=jnp.asarray(desc))
        tf = TFeatures(xy=torch.from_numpy(xy), response=torch.zeros(F),
                       angle=torch.zeros(F), level=torch.zeros(F, dtype=torch.int32),
                       valid=torch.from_numpy(valid), desc=torch.from_numpy(desc))
        empty_j = mj.is_empty()
        mj = jstate.insert_keyframe(mj, jf, jnp.asarray(depth),
                                    JSE3(jnp.asarray(q), jnp.asarray(t)),
                                    do=jnp.bool_(do))
        mj = jstate.create_map_points(
            mj, JMatch(jnp.asarray(best), jnp.asarray(z), jnp.asarray(z),
                       jnp.asarray(is_match)), *INTR,
            do=jnp.bool_(do) & ~empty_j)
        empty_t = mt.is_empty()
        mt = tstate.insert_keyframe(mt, tf, torch.from_numpy(depth),
                                    TSE3(torch.from_numpy(q), torch.from_numpy(t)),
                                    do=torch.tensor(do))
        mt = tstate.create_map_points(
            mt, TMatch(torch.from_numpy(best), torch.from_numpy(z),
                       torch.from_numpy(z), torch.from_numpy(is_match)), *INTR,
            do=torch.tensor(do) & ~empty_t)
        _assert_maps_equal(mt, mj)
    return mt, mj


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_and_fuse_ring_wrap_exact(seed):
    """20 insertions into an 8-keyframe / 64-landmark map: both rings
    wrap many times (stale-id scrubbing, id % P slots, duplicate landmark
    slots within one fusion when more than 64 are allocated)."""
    mt, _ = _run(20, seed, dup_targets=False)
    assert int(mt.num_kf) > 8 and int(mt.num_mp) > 64


def test_duplicate_target_scatter_last_lane_wins():
    """Two previous-keyframe keypoints matched to one current keypoint:
    the current slot takes the id of the LAST such lane, as JAX's CPU
    scatter does; pinned on a hand-made case and over a run."""
    m = tstate.empty_map(MAP, ORB, "cpu")
    m = m._replace(num_kf=torch.tensor(2, dtype=torch.int32))
    best = torch.zeros(F, dtype=torch.int32)
    best[3], best[10], best[40] = 7, 7, 7
    is_match = torch.zeros(F, dtype=torch.bool)
    is_match[[3, 10, 40]] = True
    z = torch.zeros(F, dtype=torch.int32)
    m = tstate.create_map_points(m, TMatch(best, z, z, is_match), *INTR)
    # lanes 3, 10, 40 allocate ids 0, 1, 2; current keypoint 7 gets 2
    assert m.kf_mp[1, 7].item() == 2
    assert m.kf_mp[0, [3, 10, 40]].tolist() == [0, 1, 2]
    _run(12, 3, dup_targets=True)


def test_window_slots_exact():
    for n in (0, 3, 8, 13):
        mj = jstate.empty_map(MAP, ORB)._replace(num_kf=jnp.int32(n))
        mt = tstate.empty_map(MAP, ORB, "cpu")._replace(
            num_kf=torch.tensor(n, dtype=torch.int32))
        for a, b in zip(tstate.window_slots(mt, 5), jstate.window_slots(mj, 5)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_liveness_uses_floor_modulo():
    m = tstate.empty_map(MAP, ORB, "cpu")._replace(
        num_mp=torch.tensor(150, dtype=torch.int32))
    ids = torch.tensor([-1, 0, 85, 86, 149, 100], dtype=torch.int32)
    mj = jstate.empty_map(MAP, ORB)._replace(num_mp=jnp.int32(150))
    np.testing.assert_array_equal(m.mp_ref_live(ids).numpy(),
                                  np.asarray(mj.mp_ref_live(jnp.asarray(ids.numpy()))))
    np.testing.assert_array_equal(m.mp_ref_slot(ids).numpy(),
                                  np.asarray(mj.mp_ref_slot(jnp.asarray(ids.numpy()))))


def test_policy_decisions_exact():
    rng = np.random.default_rng(9)
    cfg = KeyframePolicyConfig()
    for _ in range(50):
        q = rng.standard_normal((2, 4)).astype(np.float32) * [1, .05, .05, .05]
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        t = (rng.standard_normal((2, 3)) * 0.4).astype(np.float32)
        fs = int(rng.integers(5, 15))
        ratio = np.float32(rng.random())
        rj = jpolicy.should_add_keyframe(
            JSE3(jnp.asarray(q[0]), jnp.asarray(t[0])),
            JSE3(jnp.asarray(q[1]), jnp.asarray(t[1])), jnp.int32(fs),
            jnp.float32(ratio), cfg)
        rt = tpolicy.should_add_keyframe(
            TSE3(torch.from_numpy(q[0]), torch.from_numpy(t[0])),
            TSE3(torch.from_numpy(q[1]), torch.from_numpy(t[1])),
            torch.tensor(fs), torch.tensor(ratio), cfg)
        assert bool(rt) == bool(rj)


def test_convert_map_round_trip_exact():
    mt, mj = _run(10, 4, dup_targets=False)
    back = convert.map_to_torch(jax.device_get(mj), "cpu")
    _assert_maps_equal(back, mj)
    again = convert.map_to_numpy(back)
    rebuilt = jstate.MapState(**again._asdict())
    _assert_maps_equal(back, rebuilt)
