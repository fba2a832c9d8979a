"""Frozen configuration for the TPU-native keyframe SLAM pipeline.

The port's own copy of ``kbslam/config.py``, unchanged below this
docstring; tests/test_torch_copies.py holds the two equal.

Every constant here mirrors a hard-coded value in the reference
(angelo-nutu/Keyframe-Based-SLAM); citations are file:line into the
reference tree so parity is auditable. The reference has no config
system at all (values are hard-coded at use sites); this dataclass IS
the parity spec.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB frontend parameters (reference: VisualOdometry.cpp:10-16)."""

    num_features: int = 3000          # cv::ORB::create(3000, ...)
    scale_factor: float = 1.2         # pyramid scale
    num_levels: int = 8               # pyramid levels
    edge_threshold: int = 31          # border where no features detected
    patch_size: int = 31              # orientation/descriptor patch
    fast_threshold: int = 20          # FAST intensity threshold
    # Harris parameters match cv::ORB's HarrisResponses (block 7, k 0.04).
    harris_block_size: int = 7
    harris_k: float = 0.04
    # Gaussian blur applied before BRIEF sampling (cv::ORB uses 7x7, sigma 2).
    blur_kernel: int = 7
    blur_sigma: float = 2.0
    # Padded feature capacity — multiple of 128 for MXU-friendly shapes.
    max_features: int = 3072
    # Matmul precision of the Pallas patch-gather's one-hot selection
    # dots ("default" | "split3" | "highest"). The selector side is 0/1
    # (bf16 exact); "default" (one bf16 pass) only rounds the blurred
    # intensities ~0.2%, which perturbs a small fraction of BRIEF
    # comparisons. TPU A/B: track step 4.52 -> 4.10 ms, ATE 5.65 vs
    # 5.67 mm, inliers unchanged — "default" wins. "split3" (3 passes,
    # asymmetric bf16 split) is BIT-exact f32 and beats "highest"
    # (~6 passes) 1.70 vs 1.80 ms/call — the exact option if needed.
    patch_precision: str = "default"


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Brute-force Hamming kNN matcher (reference: VisualOdometry.cpp:18,35-62)."""

    ratio: float = 0.6                # Lowe ratio test (VisualOdometry.cpp:46)
    descriptor_bits: int = 256        # rBRIEF 256-bit descriptors
    cross_check: bool = False         # mutual-best filter (NOT in reference)


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """PnP-RANSAC pose estimation (reference: VisualOdometry.cpp:72-73).

    The reference uses cv::solvePnPRansac(100 iters, 8 px, 0.99 conf) with
    OpenCV's adaptive early exit; fixed shapes require a fixed hypothesis
    budget, so we run more hypotheses than the reference's cap in a single
    batched launch.
    """

    num_hypotheses: int = 128         # >= reference's 100 iterations
    # (256 -> 128 measured ATE-identical at 240x320/3-seed AND 640x480:
    # PROSAC-ordered sampling concentrates hypotheses on strong matches)
    sample_size: int = 6              # 6-point DLT minimal solver
    reproj_threshold: float = 8.0     # pixels (VisualOdometry.cpp:73)
    confidence: float = 0.99          # kept for parity bookkeeping
    min_points: int = 4               # PnP attempted iff >=4 pairs (VisualOdometry.cpp:146)
    refine_iters: int = 2             # Gauss-Newton refinement on inliers
    # (2 iterations measure ATE-identical to 10 — GN converges in 1-2
    # from the polished RANSAC winner; runs twice: wide then tight gate)
    polish_iters: int = 2             # per-hypothesis GN on minimal sets
    # (1 iteration looked ATE-identical on smooth scenes but flipped
    # RANSAC winners on the hard sphere scene, breaking the BA-helps
    # contract — keep 2)
    dlt_fraction: float = 0.125       # hypothesis share for DLT (rest Kabsch;
    # DLT only carries frames with missing current-frame depth)
    min_inliers: int = 6              # below this the solve is a failure
    # RANSAC/refinement operate on the top-M ratio-test matches (ordered
    # by Hamming distance, PROSAC-style) instead of all padded query
    # slots: typical frames carry ~1k matches out of 9216 padded slots,
    # so compaction shrinks every scoring/refinement tensor ~6x. Only
    # binds when a frame has more matches than this (then the weakest
    # are dropped). Multiple of 128 for MXU-friendly shapes. 1536 -> 1024
    # measured ATE-identical (typical frames carry ~1k ratio survivors).
    max_correspondences: int = 1024


@dataclasses.dataclass(frozen=True)
class KeyframePolicyConfig:
    """Keyframe insertion policy (reference: VisualOdometry.cpp:99-126)."""

    min_frame_gap: int = 10           # >=10 frames since last KF
    translation_threshold: float = 0.5   # metres
    rotation_threshold_deg: float = 5.0  # degrees
    min_inlier_ratio: float = 0.4     # PnP inlier ratio trigger


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window local bundle adjustment (reference: Optimizers.cpp/.hpp)."""

    window: int = 5                   # numKeyFrames=5 (Optimizers.cpp:32)
    max_iterations: int = 20          # LM cap (Optimizers.cpp:207)
    huber_delta: float = 1.0          # HuberLoss (Optimizers.hpp huber_delta)
    depth_prior_sigma: float = 0.30   # scale anchor sigma (Optimizers.hpp)
    chi2_gate: float = 5.991          # 2-dof 95% gate (Optimizers.cpp:98)
    pixel_sigma: float = 1.0          # (Optimizers.cpp:99)
    loss_alpha: float = 1.0           # w = 1/(alpha + beta z^2) (Optimizers.cpp:162-165)
    loss_beta: float = 0.25
    # RGB-D per-observation depth residuals — deliberate improvement
    # over the reference, which uses measured depth only through the
    # single anchor residual (Optimizers.cpp:173-192). On coplanar
    # scenes the reprojection-only objective has a near-null pose/plane
    # valley whose minimum is displaced tens of mm by noise (measured:
    # a converged solve on a textured-plane window moved gauge-relative
    # keyframe error 10->57 mm while REDUCING cost 49->15; with these
    # residuals the same configuration costs 2683 — far uphill).
    # Residual (z_cam(X) - z_meas)/sigma with the Kinect-style
    # quadratic sigma below, Huber-robustified and build-time gated
    # like the reprojection terms. False = strict reference objective.
    depth_residuals: bool = True
    depth_res_sigma0: float = 0.002   # sigma = max(s0*z^2, s_min) metres
    depth_res_sigma_min: float = 0.002
    depth_res_gate: float = 3.0       # build-time whitened outlier gate
    # Landmark pruning after the solve (Optimizers.cpp:225-235).
    prune_min_obs: int = 2
    prune_min_inlier_kfs: int = 2
    prune_min_inlier_ratio: float = 0.4
    # Compact solver capacities (ba/compact.py): static counts of active
    # observations / unique landmarks in a window. Multiples of 128.
    compact_obs: int = 4096
    compact_landmarks: int = 4096
    # Ceres use_inner_iterations analogue (Optimizers.cpp:207): after an
    # ACCEPTED LM step, re-linearize the landmark-only system at the new
    # cameras and take one Newton step on the points (Ceres runs
    # coordinate descent on the elimination group). Accepted only on
    # strict cost decrease, like Ceres. Default False: measured on fresh
    # tracking windows the solve's OPTIMUM is unchanged (exp_ba_fresh:
    # final costs identical across iteration budgets — the plain loop
    # already saturates) and each accepted step pays an extra cost
    # evaluation + landmark NE solve; enable for Ceres-schedule parity
    # or faster per-iteration descent on harder windows.
    inner_iterations: bool = False
    # LM damping schedule (Ceres defaults: init 1e-4, up x2 on reject, down /3).
    lm_init_lambda: float = 1e-4
    lm_lambda_up: float = 2.0
    lm_lambda_down: float = 1.0 / 3.0
    lm_min_lambda: float = 1e-10
    lm_max_lambda: float = 1e8


@dataclasses.dataclass(frozen=True)
class CullConfig:
    """Keyframe culling — implemented but DISABLED in the reference
    (Map.cpp:107-177, call commented out at Map.cpp:63)."""

    enabled: bool = False
    min_keep: int = 5
    translation_threshold: float = 1.5
    rotation_threshold: float = 0.1   # radians


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closure — a deliberate capability EXTENSION: the reference
    has no place recognition or relocalization at all (SURVEY §5.3), so
    its drift is unbounded. Disabled by default to preserve strict
    reference-parity behavior; enable for bounded-drift trajectories
    (kbslam/loop/: bag-of-binary-words detection on the MXU, geometric
    verification through the tracking frontend, SE(3) pose-graph LM)."""

    enabled: bool = False
    word_bits: int = 10               # vocabulary size = 2^word_bits
    score_min: float = 0.80           # signature cosine gate
    min_separation: int = 10          # keyframe-id gap before a loop counts
    min_inliers: int = 40             # geometric verification gate
    loop_weight: float = 1.0          # pose-graph weight of the loop edge
    max_iterations: int = 50          # pose-graph LM cap
    # Drift-envelope consistency gates: a verified constraint must lie
    # within this much of the CURRENT map's relative pose. Loop closure
    # corrects accumulated drift (bounded); constraints outside the
    # envelope are perceptual aliasing (measured: repeated synthetic
    # texture produced an 87-inlier "loop" 551 mm off while the real
    # drift was <28 mm — see loop/detect.py verify_loop).
    max_trans_disc: float = 0.30      # metres
    max_rot_disc_deg: float = 10.0
    # Relocalization after tracking loss (capability extension; the
    # reference's failure contract is skip-frame-and-hope — once the
    # camera leaves the last keyframe's view it is lost forever).
    # After this many consecutive tracking failures, the frame is
    # place-recognized against the WHOLE keyframe ring, verified with
    # mutual-best matching + PnP, and on success inserted as a fresh
    # keyframe anchor (loop/reloc.py). 0 disables.
    reloc_after: int = 0
    reloc_score_min: float = 0.5      # signature gate (frame vs ring)
    reloc_min_inliers: int = 40


@dataclasses.dataclass(frozen=True)
class DenseMapConfig:
    """Dense TSDF volume — a deliberate capability EXTENSION: the
    reference's world model is sparse landmarks only (Map.cpp), so a
    user gets no reconstructed surface, free-space map, or collision
    geometry. Disabled by default (reference parity).

    TPU-first formulation (mapping/dense.py): voxel-CENTRIC projective
    integration — every voxel center is transformed into the keyframe
    camera (batched quat rotation), projected (dense arithmetic), and
    reads its depth by ONE nearest-neighbor gather from the [H,W] depth
    image (the single gather is the cost center, ~45 ns/element,
    CLAUDE.md gotcha #7 — bilinear would pay it 4x for sub-voxel gains
    the truncation band swallows). Updates are pure where-ops on fixed
    [Nx,Ny,Nz] arrays: jit-stable shapes, no sparse bookkeeping.
    Integration runs once per KEYFRAME insertion (not per frame)."""

    enabled: bool = False
    # grid: dims voxels along each world axis, metres per voxel, and the
    # world position of voxel (0,0,0)'s minus corner. The volume lives
    # in the SLAM WORLD frame — which is the FIRST CAMERA frame (frame 0
    # is the identity gauge, pipeline.py): the default 8.2 x 8.2 x 2.7 m
    # box therefore sits IN FRONT of the start pose (+z = optical axis),
    # covering where an RGB-D rig actually sees surfaces. Offline users
    # fusing ground-truth-posed depth should place the box in that
    # trajectory's own world frame instead.
    dims: tuple = (96, 96, 32)
    voxel_size: float = 0.085
    origin: tuple = (-4.08, -4.08, 0.2)
    truncation: float = 0.25          # SDF clamp band, metres (~3 voxels)
    max_weight: float = 64.0          # running-average saturation
    # surface extraction: voxels with |tsdf| below this (in truncation
    # units) are surface candidates (mapping/dense.py surface_points)
    iso_band: float = 0.5
    min_depth: float = 0.05           # reject degenerate returns
    max_depth: float = 20.0
    # submapping (mapping/submap.py): 0 = one monolithic world-frame
    # volume (above); K > 0 = open a new submap every K keyframe
    # insertions, each a [dims] volume ANCHORED to its keyframe's
    # camera frame (``origin`` is then interpreted in that local frame
    # — the same in-front-of-the-camera box). Anchored submaps follow
    # BA and loop-closure pose corrections at extraction time; the
    # monolithic volume deliberately does not (dense.py limitations).
    submap_every: int = 0
    max_submaps: int = 16             # submap ring capacity


@dataclasses.dataclass(frozen=True)
class DenseIcpConfig:
    """Frame-to-model dense tracking against the TSDF (mapping/icp.py).

    Capability extension: the reference tracks frame-to-keyframe only
    (ORB + BFMatcher + solvePnPRansac, VisualOdometry.cpp:35-97) and
    simply loses tracking when feature matching starves (SURVEY §5.3).
    Direct SDF alignment needs no texture — geometry alone re-acquires
    or polishes the pose. Requires ``dense.enabled`` (the volume is the
    model). Modes:

      - "off": reference parity (default);
      - "rescue": on PnP failure, align the depth frame to the volume
        from the last emitted pose; accept on the gates below;
      - "refine": additionally polish every successful PnP pose,
        accepted only when the SDF RMSE strictly improves. CAUTION —
        measured unsafe as a default (benchmarks/exp_icp_ate.py): the
        volume is built from tracked poses, so the RMSE gate accepts
        ~100% of steps INCLUDING ones that reinforce baked-in drift
        (4/6 scene-seeds improved up to 25%, one regressed 3.4x).
        Rescue has no such failure mode: it only fires on frames that
        would otherwise fail outright.

    Kept separate from DenseMapConfig so ICP knob changes don't change
    the fusion jit cache key (make_integrate takes the map config)."""

    mode: str = "off"            # "off" | "rescue" | "refine"
    stride: int = 4              # pixel subsampling (P = H*W/stride^2)
    iters: int = 8               # fixed Gauss-Newton trips
    huber_m: float = 0.08        # robust scale on the SDF residual (m)
    damping: float = 1e-4        # Levenberg diagonal damping (x tr(H)/6)
    # host-side acceptance gates on the returned stats
    min_points: int = 300        # live trilinear samples required
    accept_rmse_m: float = 0.08  # post-solve robust SDF RMSE ceiling
    # With the submap atlas (dense.submap_every > 0): align against the
    # newest ``atlas_slots`` live submaps, each re-posed by its anchor
    # keyframe's CURRENT ring pose (mapping/icp.align_depth_to_atlas).
    # Cost scales linearly ([P,8] corner gather per slot). In "refine"
    # mode the ACTIVE submap is excluded from this window: the refined
    # pose must be supported by geometry whose poses are not correlated
    # with the most recent (drift-accumulating) tracking — the
    # independent-evidence gate exp_icp_ate.py's monolithic refine mode
    # lacks (volume built from tracked poses -> frame-to-model drift
    # reinforcement, one measured 3.4x ATE regression).
    atlas_slots: int = 3


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity padded map state (replaces Map/KeyFrame/MapPoint,
    reference Map.cpp / KeyFrame.hpp / MapPoint.hpp)."""

    max_keyframes: int = 64
    max_map_points: int = 65536
    depth_scale: float = 0.001        # uint16 -> metres (VisualOdometry.cpp:52)
    # Keypoints on depth discontinuities (3x3 neighbourhood spread above
    # this, in metres) have their depth zeroed: occlusion-rim corners
    # carry foreground/background-mixed depth that poisons landmarks and
    # makes BA fit cameras to phantom structure. Deliberate improvement
    # over the reference, which samples depth.at(y,x) unguarded
    # (VisualOdometry.cpp:52, Map.cpp:31) — a no-op on smooth scenes.
    # 0 disables (strict reference behavior).
    depth_edge_max_spread: float = 0.15
    # Range-aware rim-gate term: the spread threshold becomes
    # max(depth_edge_max_spread, rel * z^2) at keypoint depth z. RGB-D
    # range noise grows ~z^2, so at long range the 3x3 spread of pure
    # sensor noise exceeds any fixed threshold and the absolute-only
    # gate zeroes ALL far depth — measured catastrophic on the corridor
    # scene with a 5 mm@1m z^2 noise model (gate-on diverges ~1e10 m
    # with 0 PnP inliers from frame 1; gate-off tracks at 0.106 m,
    # because zero-mean depth noise averages out in PnP while far
    # points anchor rotation — benchmarks/exp_loop_ate.py notes). Set
    # to ~4x the sensor's sigma1 (e.g. 0.02 for 5 mm@1m) so noise-only
    # spread passes at range while true occlusion rims (metre-scale
    # depth steps) still gate near/mid field. 0 disables (absolute
    # threshold only — the default, bit-identical prior behavior).
    depth_edge_rel_per_m2: float = 0.0


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Top-level config — one frozen object carries the full parameter set."""

    image_height: int = 480
    image_width: int = 640
    # Track against the last N keyframes (1 = reference behavior:
    # match only the most recent keyframe, VisualOdometry.cpp:36-39).
    # N>1 matches a concatenated descriptor bank and solves PnP against
    # world-frame points — more correspondences, longer baselines.
    # Default 1 (reference parity): a round-4 head-to-head across 4
    # scene families x 3 seeds (benchmarks/exp_nk_ate.py) found NK=3's
    # benefit NOT demonstrable — modest refined-ATE gains on smooth
    # scenes (e.g. 13.5 vs 15.6 mm plane) but a catastrophic outlier on
    # a hard spheres seed (215 vs 44 mm) and comparable keyframe ATE —
    # while costing ~7% FPS (475 vs 511 on TPU v5e). Set 3 to trade
    # throughput for the multi-keyframe bank on smooth scenes.
    track_keyframes: int = 1
    # Keyframe insertion without lax.cond: always execute the (masked,
    # drop-scatter) insertion, gated by index arithmetic. SLOWER single
    # stream (~+0.37 ms/frame: insertion work runs every frame) but
    # REQUIRED for the vmapped multistream path, where cond lowers to
    # both-branch execution + a full-map select copy every frame
    # (~0.85 ms/stream, benchmarks/exp_multistream2.py).
    branchless_insert: bool = False
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    pnp: PnPConfig = dataclasses.field(default_factory=PnPConfig)
    policy: KeyframePolicyConfig = dataclasses.field(default_factory=KeyframePolicyConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    cull: CullConfig = dataclasses.field(default_factory=CullConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    dense: DenseMapConfig = dataclasses.field(default_factory=DenseMapConfig)
    dense_icp: DenseIcpConfig = dataclasses.field(
        default_factory=DenseIcpConfig)

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(height: int = 64, width: int = 96) -> SLAMConfig:
    """Small-capacity config for fast CPU tests and the multichip dryrun."""
    return SLAMConfig(
        image_height=height,
        image_width=width,
        orb=OrbConfig(num_features=128, num_levels=3, max_features=128),
        pnp=PnPConfig(num_hypotheses=32, refine_iters=5),
        map=MapConfig(max_keyframes=8, max_map_points=1024),
    )


DEFAULT_CONFIG = SLAMConfig()
