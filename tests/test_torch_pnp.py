"""Parity of the port's PnP (kbslam_torch.pnp) with the JAX reference,
on CPU. The solvers are the same unrolled float32 formulas, so poses
agree to float32 rounding amplified by the conditioning of each solve
(bounds per test). RANSAC is compared with the reference's own minimal
sets injected, so both solve and score the same hypotheses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import PnPConfig
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.geom.se3 import SE3 as JSE3
from kbslam.pnp import dlt as jdlt, kabsch as jkabsch, refine as jrefine
from kbslam.pnp import ransac as jransac
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.pnp import dlt as tdlt, kabsch as tkabsch, refine as trefine
from kbslam_torch.pnp import ransac as transac

torch.set_num_threads(1)
K = np.array([[260.0, 0, 159.5], [0, 260.0, 119.5], [0, 0, 1]])
JI, TI = JIntr.from_matrix(K), TIntr.from_matrix(K)


def _scene(seed, n=400, outliers=0.3, noise=0.5):
    """Keyframe-camera points, a ground-truth pose, noisy observed
    pixels with a fraction of outliers, and current-frame 3D points."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], 1).astype(np.float32)
    w = rng.standard_normal(3) * 0.05
    xi = np.concatenate([rng.standard_normal(3) * 0.1, w]).astype(np.float32)
    T = JSE3.exp(jnp.asarray(xi))
    pc = np.asarray(T.apply(jnp.asarray(pts)))
    uv = K[:2, :2] @ (pc[:, :2] / pc[:, 2:]).T + K[:2, 2:3]
    uv = (uv.T + rng.standard_normal((n, 2)) * noise).astype(np.float32)
    bad = rng.random(n) < outliers
    uv[bad] = (rng.random((bad.sum(), 2)) * [320, 240]).astype(np.float32)
    valid = rng.random(n) > 0.05
    obs = pc + rng.standard_normal((n, 3)).astype(np.float32) * 0.002
    obs[bad] += rng.standard_normal((bad.sum(), 3)).astype(np.float32)
    obs_valid = rng.random(n) > 0.2
    return pts, uv, valid, obs.astype(np.float32), obs_valid, T


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dlt_and_kabsch_minimal_solvers():
    rng = np.random.default_rng(0)
    pts, uv, _, obs, _, _ = _scene(1, outliers=0.0, noise=0.0)
    idx = np.stack([rng.choice(len(pts), 6, replace=False) for _ in range(32)])
    p6, uv6, o6 = pts[idx], uv[idx], obs[idx]
    Rj, tj = jdlt.solve_dlt(jnp.asarray(p6),
                            jdlt.normalized_rays(JI, jnp.asarray(uv6)))
    Rt, tt = tdlt.solve_dlt(_t(p6), tdlt.normalized_rays(TI, _t(uv6)))
    # float32 inverse iteration on a 12x12 normal matrix whose smallest
    # singular values sit near the float32 noise floor: the raw DLT is a
    # coarse initializer (ransac.py:114-117) and agrees to 5e-3 in R and
    # 2e-2 in t (t carries the 1/lambda scale of the eigenvector) ...
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=5e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=2e-2)
    # ... and the hypotheses RANSAC scores, after the 2-iteration GN
    # polish on the minimal set, agree to 1e-4
    from kbslam.geom.se3 import matrix_to_quat as jm2q
    from kbslam_torch.geom.se3 import matrix_to_quat as tm2q
    T0 = JSE3(jm2q(Rj), tj).normalize()
    Pj = jax.vmap(lambda q, t, p, u: jrefine.refine_pose(
        JSE3(q, t), p, u, jnp.ones(6), JI, iters=2))(
        T0.q, T0.t, jnp.asarray(p6), jnp.asarray(uv6))
    Pt = trefine.refine_pose(TSE3(tm2q(Rt), tt).normalize(), _t(p6), _t(uv6),
                             torch.ones(6), TI, iters=2)
    np.testing.assert_allclose(Pt.q.numpy(), np.asarray(Pj.q), atol=1e-4)
    np.testing.assert_allclose(Pt.t.numpy(), np.asarray(Pj.t), atol=1e-4)
    Rj, tj = jkabsch.solve_kabsch(jnp.asarray(p6), jnp.asarray(o6))
    Rt, tt = tkabsch.solve_kabsch(_t(p6), _t(o6))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


def test_refine_pose_and_two_stage():
    pts, uv, valid, _, _, T = _scene(2, outliers=0.2)
    T0 = JSE3.exp(jnp.asarray(np.r_[np.asarray(T.log())] + 0.02))
    w = valid.astype(np.float32)
    Tj = jrefine.refine_pose(T0, jnp.asarray(pts), jnp.asarray(uv),
                             jnp.asarray(w), JI, iters=4)
    Tt = trefine.refine_pose(TSE3(_t(T0.q), _t(T0.t)), _t(pts), _t(uv),
                             _t(w), TI, iters=4)
    np.testing.assert_allclose(Tt.q.numpy(), np.asarray(Tj.q), atol=1e-5)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)
    Tj = jrefine.refine_pose_two_stage(T0, jnp.asarray(pts), jnp.asarray(uv),
                                       jnp.asarray(w), jnp.asarray(valid), JI,
                                       iters=2, wide_thr2=64.0)
    Tt = trefine.refine_pose_two_stage(TSE3(_t(T0.q), _t(T0.t)), _t(pts),
                                       _t(uv), _t(w), _t(valid), TI,
                                       iters=2, wide_thr2=64.0)
    np.testing.assert_allclose(Tt.q.numpy(), np.asarray(Tj.q), atol=1e-5)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-4)


def jax_sampler(key):
    """A port sampler that returns exactly the index sets
    kbslam.pnp.ransac draws from ``key`` (ransac.py:76-92)."""
    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        key_a, key_b = jax.random.split(key)
        idx_d = jransac._sample_valid_indices(
            key_a, jnp.asarray(valid.numpy()), k_dlt, set_size, packed=packed)
        idx_k = None if pool is None else jransac._sample_valid_indices(
            key_b, jnp.asarray(pool.numpy()), k_kabsch, set_size)
        return (torch.from_numpy(np.array(idx_d)),
                None if idx_k is None else torch.from_numpy(np.array(idx_k)))
    return sample


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("with_depth", [True, False])
def test_ransac_with_injected_sets(seed, with_depth):
    """Same minimal sets in: the same winning hypothesis, hence the same
    final inlier set and the pose to float32 rounding."""
    pts, uv, valid, obs, obs_valid, _ = _scene(seed)
    cfg = PnPConfig()
    key = jax.random.PRNGKey(seed)
    extra_j = dict(points3d_obs=jnp.asarray(obs),
                   obs_valid=jnp.asarray(obs_valid)) if with_depth else {}
    extra_t = dict(points3d_obs=_t(obs), obs_valid=_t(obs_valid)) \
        if with_depth else {}
    rj = jax.device_get(jransac.ransac_pnp(
        key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), JI, cfg,
        **extra_j))
    rt = transac.ransac_pnp(_t(pts), _t(uv), _t(valid), TI, cfg,
                            jax_sampler(key), **extra_t)
    assert bool(rj.success) and bool(rt.success)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(rt.T_cw.q.numpy(), np.asarray(rj.T_cw.q),
                               atol=1e-5)
    np.testing.assert_allclose(rt.T_cw.t.numpy(), np.asarray(rj.T_cw.t),
                               atol=1e-4)
    assert float(rt.inlier_ratio) == float(rj.inlier_ratio)


def test_generator_sampler_draws_valid_sets():
    """The default sampler (``hash_sampler``): in range, among valid
    entries, deterministic per (seed, frame), another frame other sets."""
    valid = torch.zeros(500, dtype=torch.bool)
    valid[torch.randperm(500, generator=torch.Generator().manual_seed(0))[:77]] = True
    frame = torch.tensor(5, dtype=torch.int32)
    idx, idx_k = transac.hash_sampler(11, frame)(valid, valid, 64, 16, 6,
                                                 False)
    assert idx.shape == (64, 6) and idx_k.shape == (16, 6)
    assert bool(valid[idx].all()) and bool(valid[idx_k].all())
    packed, _ = transac.hash_sampler(11, frame)(torch.arange(500) < 77, None,
                                                64, 0, 6, True)
    assert int(packed.max()) < 77 and int(packed.min()) >= 0
    again, _ = transac.hash_sampler(11, frame)(valid, valid, 64, 16, 6, False)
    assert torch.equal(idx, again)
    other, _ = transac.hash_sampler(11, frame + 1)(valid, valid, 64, 16, 6,
                                                   False)
    assert not torch.equal(idx, other)
