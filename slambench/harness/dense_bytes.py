"""The bytes the dense model's two stages must move, reckoned from the
configuration (the reference's ``SLAMConfig``), not from the code that
runs, so that any implementation is read against the same work
(``metrics/dense_fuse_roofline.py``, ``metrics/dense_icp_roofline.py``).

- A keyframe's fusion into its submap reads and writes the slot's tsdf
  and weight once (4 bytes a voxel each) and reads the depth image once
  (int32 on the card).
- An ICP solve reads the depth image once and, in each of its fetches
  (``iters`` Gauss-Newton trips and the final evaluation), the 8
  corners' tsdf and weight of each of P sampled points in each of the K
  slots of its window.
"""
from __future__ import annotations

import math

FLOAT = 4           # float32 tsdf and weight
DEPTH = 4           # the depth image, widened to int32 on upload


def _depth_bytes(cfg) -> int:
    return cfg.image_height * cfg.image_width * DEPTH


def fuse_bytes(cfg) -> int:
    """Bytes of one keyframe's fusion into one slot."""
    voxels = math.prod(cfg.dense.dims)
    return 2 * 2 * FLOAT * voxels + _depth_bytes(cfg)


def icp_bytes(cfg) -> int:
    """Bytes of one ICP solve against ``dense_icp.atlas_slots`` slots."""
    icp = cfg.dense_icp
    points = (-(-cfg.image_height // icp.stride)
              * -(-cfg.image_width // icp.stride))
    fetches = icp.iters + 1
    return (_depth_bytes(cfg)
            + fetches * 8 * 2 * FLOAT * points * icp.atlas_slots)
