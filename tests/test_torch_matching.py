"""Exact parity of the port's Hamming matcher and row gathers with the
JAX reference, on the same numpy inputs, on CPU. Everything here is
integer or selection arithmetic, so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.matching.hamming import (hamming_distance_matrix as j_ham,
                                     knn2_ratio_match as j_knn)
from kbslam.ops.incidence import (incidence_apply as j_apply,
                                  incidence_gather as j_gather)
from kbslam_torch.matching.hamming import (hamming_distance_matrix as t_ham,
                                           knn2_ratio_match as t_knn)
from kbslam_torch.ops.incidence import SumById
from kbslam_torch.ops.incidence import (incidence_apply as t_apply,
                                        incidence_gather as t_gather)

torch.set_num_threads(1)


def _descriptors(seed, nq=300, nt=260):
    """Query/train bits where many train rows are noisy copies of query
    rows (real matches), some exact duplicates (argmin ties) and the
    rest random; validity masks with holes."""
    rng = np.random.default_rng(seed)
    q = (rng.random((nq, 256)) > 0.5).astype(np.uint8)
    t = (rng.random((nt, 256)) > 0.5).astype(np.uint8)
    src = rng.choice(nq, nt // 2, replace=False)
    flips = rng.random((nt // 2, 256)) < 0.05
    t[: nt // 2] = q[src] ^ flips
    t[nt // 2: nt // 2 + 20] = t[:20]           # duplicate train rows
    qv = rng.random(nq) > 0.1
    tv = rng.random(nt) > 0.1
    return q, qv, t, tv


def test_distance_matrix_exact():
    q, _, t, _ = _descriptors(0)
    np.testing.assert_array_equal(
        t_ham(torch.from_numpy(q), torch.from_numpy(t)).numpy(),
        np.asarray(j_ham(jnp.asarray(q), jnp.asarray(t))))


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_knn2_ratio_match_exact(seed, cross_check):
    q, qv, t, tv = _descriptors(seed)
    rj = j_knn(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t),
               jnp.asarray(tv), 0.6, cross_check=cross_check)
    rt = t_knn(torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(t),
               torch.from_numpy(tv), 0.6, cross_check=cross_check)
    assert np.asarray(rj.is_match).sum() > 50
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_knn2_all_invalid():
    q, qv, t, tv = _descriptors(2)
    rj = j_knn(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t),
               jnp.zeros_like(jnp.asarray(tv)), 0.6)
    rt = t_knn(torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(t),
               torch.zeros(len(tv), dtype=torch.bool), 0.6)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("exact", [True, False])
def test_incidence_gather_exact(exact):
    """Out-of-range ids (== T, > T, < 0) select zero rows; exact=False is
    the bf16-rounded table, exactly as the one-hot bf16 matmul gives."""
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((50, 5)) * 300).astype(np.float32)
    ids = rng.integers(-3, 55, 200).astype(np.int32)
    ids[:3] = [50, -1, 0]
    np.testing.assert_array_equal(
        t_gather(torch.from_numpy(ids), torch.from_numpy(table), exact).numpy(),
        np.asarray(j_gather(jnp.asarray(ids), jnp.asarray(table), exact)))


@pytest.mark.parametrize("exact", [True, False])
def test_incidence_apply_matches(exact):
    """Sum-by-id: the same bf16 operand rounding; float32 sums in another
    order (relative 1e-5)."""
    rng = np.random.default_rng(6)
    values = rng.standard_normal((300, 4)).astype(np.float32)
    ids = rng.integers(0, 41, 300).astype(np.int32)   # 40 = dropped
    ref = np.asarray(j_apply(jnp.asarray(ids), 40, jnp.asarray(values), exact))
    got = t_apply(torch.from_numpy(ids), 40, torch.from_numpy(values),
                  exact).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["mixed", "runs", "all_dropped"])
def test_sum_by_id_adds_in_row_order(case):
    """One plan, two value sets: each sum equals, bit for bit, the float32
    sum that adds the rows of an id in their order (``np.add.at``), with
    ids < 0 or >= n dropped and ids without rows summing to zero."""
    rng = np.random.default_rng(7)
    n, rows = 40, 500
    if case == "mixed":
        ids = rng.integers(-3, n + 4, rows)
    elif case == "runs":       # few ids, long runs, as the sums by camera
        ids = rng.integers(0, 5, rows)
    else:
        ids = np.full(rows, n)
    ids = ids.astype(np.int32)
    plan = SumById(torch.from_numpy(ids), n)
    kept = (ids >= 0) & (ids < n)
    for k in range(2):
        values = (rng.standard_normal((rows, 6)) * 10 ** k).astype(np.float32)
        ref = np.zeros((n, 6), np.float32)
        np.add.at(ref, ids[kept], values[kept])
        got = plan(torch.from_numpy(values), exact=True).numpy()
        assert got.dtype == np.float32 and got.shape == (n, 6)
        np.testing.assert_array_equal(got, ref)
