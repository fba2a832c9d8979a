"""TUM RGB-D dataset reader (fr1/fr2/fr3 format): the port's own copy of
kbslam/io/tum.py, equal to it below this docstring but for the package
name (the port imports nothing of kbslam/).

Standard format: ``rgb.txt`` / ``depth.txt`` / optional
``groundtruth.txt`` index files with timestamped file paths; depth PNGs
are 16-bit with scale 1/5000 m, so SLAMConfig.map.depth_scale must be
set from ``TUMDataset.depth_scale``.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _read_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_groundtruth(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            # tx ty tz qx qy qz qw
            out.append((v[0], np.asarray(v[1:8])))
    return out


def _associate(a, b, max_dt=0.02):
    """One-to-one timestamp association (the standard TUM associate.py
    logic): enumerate candidate pairs within max_dt, sort by |dt|, and
    greedily take pairs whose rgb AND depth entries are both unused —
    no depth frame is ever paired with two rgb frames. Output is
    ordered by rgb timestamp."""
    tb = np.asarray([x[0] for x in b])
    cands = []
    for i, (ta, _) in enumerate(a):
        lo = int(np.searchsorted(tb, ta - max_dt, side="left"))
        hi = int(np.searchsorted(tb, ta + max_dt, side="right"))
        for j in range(lo, hi):
            cands.append((abs(tb[j] - ta), i, j))
    cands.sort()
    used_a, used_b = set(), set()
    picks = []
    for _, i, j in cands:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            picks.append((i, j))
    picks.sort()
    return [(a[i], b[j]) for i, j in picks]


class TUMDataset:
    """Iterates (rgb uint8 [H,W,3], depth uint16 [H,W], mask, T_wc or None)."""

    # default fr1 intrinsics; fr2/fr3 use their own (pass K explicitly)
    DEFAULT_K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]])
    depth_scale = 1.0 / 5000.0

    def __init__(self, root: str, K: Optional[np.ndarray] = None,
                 max_dt: float = 0.02):
        self.root = root
        self.K = K if K is not None else self.DEFAULT_K
        rgb = _read_index(os.path.join(root, "rgb.txt"))
        depth = _read_index(os.path.join(root, "depth.txt"))
        self.pairs = _associate(rgb, depth, max_dt)
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = _read_groundtruth(gt_path) if os.path.exists(gt_path) else None

    def __len__(self) -> int:
        return len(self.pairs)

    def gt_pose_at(self, t: float) -> Optional[np.ndarray]:
        if not self.groundtruth:
            return None
        ts = [g[0] for g in self.groundtruth]
        i = int(np.argmin(np.abs(np.asarray(ts) - t)))
        tx, ty, tz, qx, qy, qz, qw = self.groundtruth[i][1]
        from scipy.spatial.transform import Rotation

        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
        T[:3, 3] = [tx, ty, tz]
        return T

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, None, Optional[np.ndarray]]]:
        """Streams frames through the native prefetching decoder when
        available (kbslam/io/native_loader.py), else PIL."""
        if not self.pairs:
            return
        from PIL import Image

        first = np.asarray(
            Image.open(os.path.join(self.root, self.pairs[0][0][1])))
        h, w = first.shape[:2]

        from kbslam_torch.io.native_loader import NativeFrameLoader

        rgb_paths = [os.path.join(self.root, p[0][1]) for p in self.pairs]
        d_paths = [os.path.join(self.root, p[1][1]) for p in self.pairs]
        loader = NativeFrameLoader(rgb_paths, d_paths, h, w)
        try:
            for (t_rgb, _), _ in self.pairs:
                out = loader.next()
                if out is None:
                    return
                rgb, depth = out
                yield rgb, depth, None, self.gt_pose_at(t_rgb)
        finally:
            loader.close()
