"""Tests of the port on a CUDA device (marker ``cuda``; they skip
without one). This file imports neither JAX nor the kbslam package, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
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
from kbslam_torch.pipeline import init_state, make_track_step
from kbslam_torch.pnp.ransac import draw_valid_indices
from kbslam_torch.slam import pose_T

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
    """Minimal sets drawn on the CPU from a fixed seed, then moved to the
    tensors' device, so CPU and CUDA runs solve the same hypotheses."""
    g = torch.Generator().manual_seed(1000 + frame_count)

    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        dev = valid.device
        idx_d = draw_valid_indices(g, valid.cpu(), k_dlt, set_size, packed)
        idx_k = (None if pool is None else
                 draw_valid_indices(g, pool.cpu(), k_kabsch, set_size))
        return idx_d.to(dev), None if idx_k is None else idx_k.to(dev)
    return sample


def test_tracking_step_cuda_matches_cpu(cuda_device):
    """The tracking step on the card against the same step on the CPU
    (the CPU runs the plain describe twin): the same keyframe and success
    decisions, poses within 1 cm and 0.5 deg (float32 sums in another
    order on the card). The card's step launches the describe kernel
    once per frame and the patch kernel never."""
    seq = synthetic.render_sequence(num_frames=12, height=240, width=320)
    cfg = config.SLAMConfig(
        image_height=240, image_width=320,
        orb=config.OrbConfig(num_features=512, num_levels=4, max_features=512),
        map=config.MapConfig(max_keyframes=16, max_map_points=8192))
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
