"""GPU smoke run of the PyTorch port (kbslam_torch) of kbslam.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one line or more; any failure raises and exits
non-zero):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile the port's CUDA kernels from kbslam_torch/csrc,
                one nvcc per source, in parallel;
  3. patches  — the patch-extraction kernel (the 1:1 counterpart of the
                TPU kernel) against its plain PyTorch twin at the
                tracking step's shapes (bit-equal), timed beside the
                twin and one PyTorch call (unfold and index) that
                computes the same patches;
  4. describe — the fused describe kernel (patch, IC angle and rBRIEF
                bits in shared memory) against its plain composition on
                the tracking shapes, an odd count, a tiny pyramid and the
                real keypoints of one synthetic 640x480 frame: angles
                within 2e-4 rad, equal bins and bits on every keypoint
                away from a bin's rounding edge, >= 99.9% bit-identical;
                timed beside the plain composition and the path it
                replaces (patch kernel + plain angle and bit stages);
  5. slice    — the tracking step (SLAM with local BA off) over a 60-frame
                640x480 synthetic RGB-D sequence at the default
                configuration; every frame launches the describe kernel
                once and the patch kernel never, tracks with >= 50
                inliers, and the trajectory error stays under 5 cm.
Then one JSON line about the kernels, the nvidia-smi line, and the
result line.

Times: device time per call, from CUDA events around the replay of a
CUDA graph of 20 calls (so a wrapper's host time is not counted), and
for each kernel also back-to-back eager calls, host time included.
Bounds: the least time for a kernel's work at 3.35 TB/s of HBM and 67
TFLOP/s of float32 (H100 SXM), counting each input byte the run's data
needs once (the pyramid pixels the windows cover) and each output byte
once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 60
MIN_INLIERS = 50
MAX_ATE_M = 0.05       # the bound of tests/test_pipeline.py
ANGLE_TOL = 2e-4       # rad, the bound of tests/test_torch_frontend.py
EDGE_MARGIN = 1e-3     # bins: nearer a .5 edge the twin may round the other way
MIN_IDENTICAL = 0.999  # share of keypoints with all 256 bits equal
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
S = 40


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of back-to-back eager calls, by CUDA events
    after warm-up: the device's time or the host's, whichever is longer
    (a wrapper's Python and checks are the host's)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed under CUDA events, so the host's time per call is
    not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):      # warm-up: caches, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def patch_inputs(h, w, n, seed, dev):
    """A stacked [8, h, w] pyramid (level l in its top-left corner, as the
    frontend builds it) and n keypoint origins, a third at or past a
    level's far edge; clamped as kbslam_torch.frontend.brief does."""
    from kbslam_torch.frontend.image import pyramid_sizes

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
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (stacked, level, y0.astype(np.int32), x0.astype(np.int32))]


def clamped_origins(stacked, level, y0, x0):
    L, H, W = stacked.shape
    return (level.long().clamp(0, L - 1), y0.long().clamp(0, H - S),
            x0.long().clamp(0, W - S))


def covered_bytes(stacked, level, y0, x0) -> int:
    """Bytes of pyramid the patches cover, each pixel counted once."""
    lv, y, x = clamped_origins(stacked, level, y0, x0)
    r = torch.arange(S, device=stacked.device)
    seen = torch.zeros(stacked.shape, dtype=torch.bool, device=stacked.device)
    seen[lv[:, None, None], (y[:, None] + r)[:, :, None],
         (x[:, None] + r)[:, None, :]] = True
    return int(seen.sum()) * stacked.element_size()


def bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by) of a kernel's work on an H100 SXM."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def describe_check(got, ref):
    """The describe gates; returns the counts it printed and the angle
    error. Raises when a gate fails."""
    from kbslam_torch.frontend import brief

    (ga, gb), (ra, rb) = got, ref
    if ga.shape != ra.shape or gb.shape != rb.shape or gb.dtype != torch.uint8:
        raise AssertionError(f"describe shapes {ga.shape} {gb.shape} {gb.dtype}")
    if not torch.isfinite(ga).all() or int(gb.max()) > 1:
        raise AssertionError("describe: non-finite angle or a bit not in {0,1}")
    err = float((ga - ra).abs().max())
    frac = brief.angle_frac(ra).cpu().double().numpy()
    away = np.abs(frac - np.floor(frac) - 0.5) >= EDGE_MARGIN
    kbin = brief.angle_bins(ga.cpu()).numpy()   # the kernel's float32 ops
    rbin = brief.angle_bins(ra).cpu().numpy()   # the bins the twin used
    same = (gb == rb).all(1).cpu().numpy()
    counts = dict(n=len(same), near_edge=int((~away).sum()),
                  bin_diff=int((kbin != rbin).sum()),
                  bin_diff_away=int(((kbin != rbin) & away).sum()),
                  rows_diff=int((~same).sum()),
                  rows_diff_away=int((~same & away).sum()),
                  max_angle_err=err)
    if (err > ANGLE_TOL or counts["bin_diff_away"] or counts["rows_diff_away"]
            or same.mean() < MIN_IDENTICAL):
        raise AssertionError(f"describe kernel disagrees with its twin: {counts}")
    return counts


def real_frame_inputs(dev):
    """The describe call's inputs on one synthetic 640x480 frame, caught
    on their way through the frontend."""
    from kbslam_torch import config
    from kbslam_torch.frontend import orb
    from kbslam_torch.io import synthetic

    seq = synthetic.render_sequence(num_frames=2, height=480, width=640)
    caught = {}
    real = orb.describe_keypoints

    def catch(*args, **kwargs):
        caught["args"], caught["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    orb.describe_keypoints = catch
    try:
        feats = orb.extract(torch.from_numpy(seq.rgb[1]).to(dev), None,
                            config.SLAMConfig().orb)
    finally:
        orb.describe_keypoints = real
    return caught["args"], caught["kwargs"]["radius"], int(feats.count())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kbslam_torch import config
    from kbslam_torch.device import pick_device
    from kbslam_torch.eval import trajectory
    from kbslam_torch.frontend import brief
    from kbslam_torch.io import synthetic
    from kbslam_torch.ops import _build
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.ops import patches as patch_ops
    from kbslam_torch.slam import SLAM

    # 1. device
    dev = pick_device()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    regs = [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {built.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(cached={built.cached}) {' | '.join(regs)}", flush=True)

    # 3. the patch kernel against its plain twin and the one-call yardstick
    cases = [(480, 640, 3072), (480, 640, 3071), (64, 96, 130)]
    for h, w, n in cases:
        args = patch_inputs(h, w, n, seed=n, dev=dev)
        got = patch_ops.extract_patches(*args)
        ref = patch_ops.extract_patches_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"patch kernel != plain twin at {h}x{w} n={n}")
    args = patch_inputs(480, 640, 3072, seed=0, dev=dev)
    st = args[0]
    lv, yy, xx = clamped_origins(*args)

    def unfold_call():
        return st.unfold(1, S, 1).unfold(2, S, 1)[lv, yy, xx]

    if not torch.equal(unfold_call(), patch_ops.extract_patches(*args)):
        raise AssertionError("unfold yardstick != patch kernel")
    p_plain = cuda_ms(lambda: patch_ops.extract_patches_reference(*args))
    p_ms = cuda_ms(lambda: patch_ops.extract_patches(*args))
    p_lib = cuda_ms(unfold_call)
    p_lib2 = cuda_ms(unfold_call)
    p_ms2 = cuda_ms(lambda: patch_ops.extract_patches(*args))
    p_plain2 = cuda_ms(lambda: patch_ops.extract_patches_reference(*args))
    p_eager = eager_ms(lambda: patch_ops.extract_patches(*args))
    n = args[1].shape[0]
    p_cov = covered_bytes(*args)
    p_bytes = p_cov + 3 * 4 * n + n * S * S * 4
    p_bound, p_by = bound(p_bytes)
    print(f"[patches] bit-equal to plain on {cases}; 3072 patches of "
          f"[8,480,640]: kernel {p_ms:.4f}/{p_ms2:.4f} ms, plain "
          f"{p_plain:.4f}/{p_plain2:.4f} ms, unfold+index "
          f"{p_lib:.4f}/{p_lib2:.4f} ms (device time, CUDA graph); eager "
          f"back-to-back kernel calls {p_eager:.4f} ms; bytes {p_bytes} "
          f"({p_cov} of pyramid "
          f"covered), bound {p_bound * 1e3:.2f} us by {p_by}, kernel at "
          f"{p_bound / p_ms:.1%} of it", flush=True)

    # 4. the fused describe kernel against its plain composition
    max_err = 0.0
    for h, w, n in cases:
        args = patch_inputs(h, w, n, seed=n, dev=dev)
        got = describe_ops.describe_keypoints(*args)
        torch.cuda.synchronize()
        counts = describe_check(got, describe_ops.describe_keypoints_reference(
            *args))
        max_err = max(max_err, counts["max_angle_err"])
        print(f"[describe] {h}x{w} {counts}", flush=True)
    real_args, radius, n_valid = real_frame_inputs(dev)
    got = describe_ops.describe_keypoints(*real_args, radius=radius)
    counts = describe_check(got, describe_ops.describe_keypoints_reference(
        *real_args, radius=radius))
    max_err = max(max_err, counts["max_angle_err"])
    print(f"[describe] one synthetic 640x480 frame through orb ({n_valid} "
          f"valid keypoints of {counts['n']}): {counts}", flush=True)

    args = patch_inputs(480, 640, 3072, seed=0, dev=dev)
    n = args[1].shape[0]

    def replaced_path():      # the patch kernel + the plain angle and bits
        patches = patch_ops.extract_patches(*args).reshape(n, S * S)
        angle = brief.ic_angles(patches, radius=15)
        return angle, brief.bits_from_patches(patches, angle)

    if not torch.equal(replaced_path()[1],
                       describe_ops.describe_keypoints_reference(*args)[1]):
        raise AssertionError("patch kernel path != plain describe")
    d_ms = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    d_plain = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    d_old = cuda_ms(replaced_path)
    d_old2 = cuda_ms(replaced_path)
    d_plain2 = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    d_ms2 = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    d_eager = eager_ms(lambda: describe_ops.describe_keypoints(*args))
    ref_bins = brief.angle_bins(describe_ops.describe_keypoints_reference(
        *args)[0])
    d_cov = covered_bytes(*args)
    table_bytes = int(torch.unique(ref_bins).numel()) * 256 * 2 * 2
    d_bytes = d_cov + 3 * 4 * n + table_bytes + n * (4 + 256)
    disc = int(((np.arange(S) - 20)[:, None] ** 2
                + (np.arange(S) - 20)[None, :] ** 2 <= 15 * 15).sum())
    d_flops = n * (4 * disc + 3 * 256)  # moments; 2 roundings + 1 subtract
    d_bound, d_by = bound(d_bytes, d_flops)
    print(f"[describe] 3072 keypoints of [8,480,640]: kernel "
          f"{d_ms:.4f}/{d_ms2:.4f} ms, plain {d_plain:.4f}/{d_plain2:.4f} ms, "
          f"replaced path (patch kernel + plain stages) {d_old:.4f}/"
          f"{d_old2:.4f} ms (device time, CUDA graph); eager back-to-back "
          f"kernel calls {d_eager:.4f} ms; bytes {d_bytes} ({d_cov} of "
          f"pyramid covered, "
          f"{table_bytes} of pair table, {n * 260} written), {d_flops} flop; "
          f"bound {d_bound * 1e3:.2f} us by {d_by}, kernel at "
          f"{d_bound / d_ms:.1%} of it", flush=True)

    # 5. the tracking slice at the default configuration
    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    torch.cuda.synchronize()
    patch_ops.reset_launches()
    describe_ops.reset_launches()
    t0 = time.perf_counter()
    walls = []
    for i in range(FRAMES):
        t1 = time.perf_counter()
        slam.process(seq.rgb[i], seq.depth[i])
        walls.append(time.perf_counter() - t1)
    total = time.perf_counter() - t0
    launches = {"describe_keypoints": describe_ops.launches,
                "extract_patches": patch_ops.launches}
    if launches != {"describe_keypoints": FRAMES, "extract_patches": 0}:
        raise AssertionError(f"kernel launches in {FRAMES} frames: {launches}")
    diags = slam.diagnostics
    bad = [d["frame"] for d in diags[1:]
           if not d["success"] or d["num_inliers"] < MIN_INLIERS]
    if bad:
        raise AssertionError(f"tracking failed or < {MIN_INLIERS} inliers "
                             f"on frames {bad}")
    est = np.stack(slam.frame_poses)
    ate = trajectory.ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3])
    if not np.isfinite(est).all() or not ate < MAX_ATE_M:
        raise AssertionError(f"ATE {ate} m (bound {MAX_ATE_M})")
    steady = np.asarray(walls[1:]) * 1e3
    print(f"[slice] {FRAMES} frames 640x480, {slam.num_keyframes} keyframes, "
          f"min inliers {min(d['num_inliers'] for d in diags[1:])}, "
          f"ATE {ate * 1e3:.2f} mm, launches {launches}; "
          f"{FRAMES / total:.2f} FPS over all frames, median "
          f"{np.median(steady):.2f} ms/frame after the first "
          f"(first {walls[0] * 1e3:.1f} ms); {smi}", flush=True)

    ref_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kbslam") + os.sep
    loaded = [m for m, mod in list(sys.modules.items())
              if m == "jax" or m.startswith("jax.") or m == "kbslam"
              or m.startswith("kbslam.")
              or (getattr(mod, "__file__", None) or "").startswith(ref_dir)]
    if loaded:
        raise AssertionError(f"the port loaded JAX or kbslam/: {loaded}")

    print(json.dumps({"kernels": [
        {"name": "describe_keypoints", "route": "cuda",
         "source": "kbslam_torch/csrc/describe.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["describe_keypoints"], "max_abs_err": max_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": None},
        {"name": "extract_patches", "route": "cuda",
         "source": "kbslam_torch/csrc/patches.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["extract_patches"], "max_abs_err": 0.0,
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": p_lib}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
