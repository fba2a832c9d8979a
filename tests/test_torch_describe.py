"""The fused describe stage (kbslam_torch.ops.describe) against the JAX
reference, on CPU.

The CUDA kernel cannot run here, so this file holds what it computes:
- its plain twin against ``kbslam.frontend.brief``'s extract_patches ->
  ic_angles -> bits_from_patches on seeded pyramids;
- its pair table and bit arithmetic (bf16 round-to-nearest-even of both
  operands, then I2 - I1 > 0 in float32), evaluated in numpy for every
  one of the 30 bins, against bits_from_patches;
- its bin formula (remainder by 2 pi, divide by 2 pi, times 30, round
  half to even, modulo 30, all in float32), fed angles on and near the
  bin boundaries, at +-pi and at 2 pi.
The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.frontend import brief as jbrief
from kbslam.frontend.image import pyramid_sizes
from kbslam_torch.frontend import brief as tbrief
from kbslam_torch.ops import describe as tdescribe

torch.set_num_threads(1)
S = 40
BINS = 30
TWO_PI32 = np.float32(2 * np.pi)


def _pyramid(h, w, seed):
    """[8, h, w] stacked 'pyramid' (level l in its top-left corner, zeros
    elsewhere, like orb.detect_and_compute) + [8, 2] level dims."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(pyramid_sizes(h, w, 8, 1.2), np.int32)
    stacked = np.zeros((8, h, w), np.float32)
    for lv, (hl, wl) in enumerate(sizes):
        stacked[lv, :hl, :wl] = rng.random((hl, wl), np.float32) * 255
    return stacked, sizes


def _keypoints(sizes, n, seed):
    """n level-coordinate keypoints, a third on or past a level's far
    edge, plus the corners and far outside."""
    rng = np.random.default_rng(seed)
    level = rng.integers(0, len(sizes), n).astype(np.int32)
    hw = sizes[level].astype(np.float32)
    xy = rng.random((n, 2)).astype(np.float32) * hw[:, ::-1]
    edge = rng.random(n) < 0.33
    xy[edge] = (hw[edge, ::-1] - 1 + rng.integers(-3, 25, (edge.sum(), 2))
                ).astype(np.float32)
    xy[:4] = [[0.0, 0.0], [-7.5, 3.5], [1e4, 1e4], [20.5, 19.5]]
    return xy, level


def _jax_bins(angle):
    """The bin formula of kbslam/frontend/brief.py:bits_from_patches."""
    frac = jnp.mod(jnp.asarray(angle), 2.0 * jnp.pi) / (2.0 * jnp.pi) * BINS
    return np.asarray(jnp.mod(jnp.round(frac).astype(jnp.int32), BINS)), \
        np.asarray(frac)


def _off_boundary(frac, margin=1e-3):
    """True where frac lies at least ``margin`` from a .5 rounding edge."""
    return np.abs(np.abs(frac - np.floor(frac) - 0.5)) >= margin


@pytest.mark.parametrize("h,w,n", [(240, 320, 384), (64, 96, 130)])
def test_reference_matches_jax_stages(h, w, n):
    """Angles within 2e-4 rad (the bound of test_torch_frontend: ~700
    float32 products summed in another order, magnified by small net
    moments). Bins equal wherever the reference's fraction is 1e-3 or
    more from a rounding edge; bits exact given equal angles."""
    stacked, sizes = _pyramid(h, w, seed=n)
    xy, level = _keypoints(sizes, n, seed=n + 1)
    pj = jbrief.extract_patches(jnp.asarray(stacked), jnp.asarray(sizes),
                                jnp.asarray(xy), jnp.asarray(level))
    aj = np.asarray(jbrief.ic_angles(pj))
    dj = np.asarray(jbrief.bits_from_patches(pj, jnp.asarray(aj)))

    y0, x0 = tbrief.patch_origins(torch.from_numpy(sizes),
                                  torch.from_numpy(xy), torch.from_numpy(level))
    at, dt = tdescribe.describe_keypoints(torch.from_numpy(stacked),
                                          torch.from_numpy(level), y0, x0)
    at, dt = at.numpy(), dt.numpy()
    assert at.shape == (n,) and at.dtype == np.float32
    assert dt.shape == (n, 256) and dt.dtype == np.uint8
    np.testing.assert_allclose(at, aj, rtol=0, atol=2e-4)

    bj, frac = _jax_bins(aj)
    bt = tbrief.angle_bins(torch.from_numpy(at)).numpy()
    away = _off_boundary(frac)
    assert away.mean() > 0.99
    np.testing.assert_array_equal(bt[away], bj[away])
    np.testing.assert_array_equal(dt[bt == bj], dj[bt == bj])
    # given the port's own angles the reference computes the same bits
    dj_at = np.asarray(jbrief.bits_from_patches(pj, jnp.asarray(at)))
    np.testing.assert_array_equal(dt, dj_at)


def _bf16_rn(x):
    """float32 -> bfloat16 -> float32, round to nearest even: what the
    kernel's __float2bfloat16_rn does to each operand."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_pair_table_gives_the_bits_of_every_bin():
    """Each bin's 256 tests, evaluated from the [30, 256, 2] table as the
    kernel does, against bits_from_patches at that bin's centre angle.
    Patches mix fractional values (bf16 rounding decides some tests) and
    a few distinct integers (many equal pairs, whose bit is 0)."""
    table = tdescribe.pair_table()
    assert table.shape == (BINS, 256, 2) and table.dtype == np.int16
    assert table.min() >= 0 and table.max() < S * S
    zero_rows = ~np.any(jbrief._rotated_selection_matrices() != 0, axis=-1)
    coincide = table[..., 0] == table[..., 1]
    np.testing.assert_array_equal(coincide, zero_rows)
    assert coincide.sum() > 0      # the coinciding-point rows are covered

    rng = np.random.default_rng(7)
    per_bin = 12
    patches = (rng.random((BINS * per_bin, S * S)) * 255).astype(np.float32)
    patches[::3] = rng.integers(100, 104, (patches[::3].shape)).astype(
        np.float32)
    bins = np.repeat(np.arange(BINS), per_bin)
    angle = (TWO_PI32 * bins.astype(np.float32) / np.float32(BINS))
    assert (_jax_bins(angle)[0] == bins).all()
    ref = np.asarray(jbrief.bits_from_patches(jnp.asarray(patches),
                                              jnp.asarray(angle)))
    q = _bf16_rn(patches)
    rows = np.arange(len(bins))[:, None]
    i1 = table[bins, :, 0].astype(np.int64)
    i2 = table[bins, :, 1].astype(np.int64)
    got = (q[rows, i2] - q[rows, i1] > 0).astype(np.uint8)
    for b in range(BINS):
        sel = bins == b
        np.testing.assert_array_equal(got[sel], ref[sel], err_msg=f"bin {b}")
    assert 0 < ref.mean() < 1


def _kernel_bins(angle):
    """describe.cu's bin, step by step in float32: fmodf by 2 pi, add
    2 pi when negative, divide by 2 pi, times 30, rintf, modulo 30."""
    t = np.asarray(angle, np.float32)
    md = np.fmod(t, TWO_PI32)
    md = np.where(md < 0, md + TWO_PI32, md).astype(np.float32)
    frac = (md / TWO_PI32).astype(np.float32) * np.float32(BINS)
    return np.rint(frac).astype(np.int64) % BINS


def test_kernel_bin_formula_matches_the_twins():
    """At and near every bin boundary, at +-pi, +-2 pi, 0 and -0. The
    twin's float32 ops on the CPU are the kernel's, so the torch bins are
    equal everywhere; the JAX reference's bins are equal away from the
    boundaries (on the card the twin's division by a scalar becomes a
    multiply by its reciprocal, an ulp off, so there too only bins away
    from the boundaries are compared)."""
    k = np.arange(-2 * BINS, 3 * BINS)
    edges = (2 * np.pi * (k + 0.5) / BINS).astype(np.float32)
    centres = (2 * np.pi * k / BINS).astype(np.float32)
    rng = np.random.default_rng(3)
    angle = np.concatenate([
        edges, centres,
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        edges + np.float32(2e-4), edges - np.float32(2e-4),
        np.float32([np.pi, -np.pi, 2 * np.pi, -2 * np.pi, 0.0, -0.0,
                    1e-8, -1e-8, np.nextafter(np.float32(np.pi), 0)]),
        rng.uniform(-np.pi, np.pi, 5000).astype(np.float32),
    ]).astype(np.float32)
    mirror = _kernel_bins(angle)
    assert mirror.min() >= 0 and mirror.max() < BINS
    twin = tbrief.angle_bins(torch.from_numpy(angle)).numpy()
    np.testing.assert_array_equal(mirror, twin)
    bj, frac = _jax_bins(angle)
    away = _off_boundary(frac)
    assert 0 < away.sum() < len(angle)
    np.testing.assert_array_equal(mirror[away], bj[away])
    # -pi and +pi are one direction: bin 15 both
    at_pi = np.isin(angle, np.float32([np.pi, -np.pi]))
    assert at_pi.sum() >= 2 and set(mirror[at_pi].tolist()) == {15}


def test_cpu_tensors_use_the_plain_twin_and_count_nothing():
    stacked, sizes = _pyramid(64, 96, seed=0)
    xy, level = _keypoints(sizes, 10, seed=1)
    y0, x0 = tbrief.patch_origins(torch.from_numpy(sizes),
                                  torch.from_numpy(xy), torch.from_numpy(level))
    before = tdescribe.launches
    a, d = tdescribe.describe_keypoints(torch.from_numpy(stacked),
                                        torch.from_numpy(level), y0, x0)
    ra, rd = tdescribe.describe_keypoints_reference(
        torch.from_numpy(stacked), torch.from_numpy(level), y0, x0)
    assert tdescribe.launches == before
    assert torch.equal(a, ra) and torch.equal(d, rd)


def test_origins_match_the_reference_clamp():
    """patch_origins is the reference's clamp
    (kbslam/frontend/brief.py:112-123), including levels smaller than
    the patch."""
    _, sizes = _pyramid(64, 96, seed=0)
    xy, level = _keypoints(sizes, 200, seed=5)
    y0, x0 = tbrief.patch_origins(torch.from_numpy(sizes),
                                  torch.from_numpy(xy), torch.from_numpy(level))
    base = np.round(xy).astype(np.int32)
    hw = sizes[level]
    np.testing.assert_array_equal(
        x0.numpy(), np.clip(base[:, 0] - 20, 0, np.maximum(hw[:, 1] - S, 0)))
    np.testing.assert_array_equal(
        y0.numpy(), np.clip(base[:, 1] - 20, 0, np.maximum(hw[:, 0] - S, 0)))
    assert y0.dtype == x0.dtype == torch.int32
