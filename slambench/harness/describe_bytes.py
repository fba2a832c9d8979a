"""The bytes the describe stage must move for a frame, from its shapes and
the keypoints' patch origins.

``covered_bytes`` is ``chip_smoke.covered_bytes``: every pyramid pixel
that some keypoint's 40x40 patch covers, counted once. The stage writes
an angle (4 bytes) and 256 bits (256 bytes) per keypoint slot. The
origins come from the reference's own frontend on the same frame
(``frame_bytes``), so the count does not depend on the program.
"""
from __future__ import annotations

import contextlib

import torch

PATCH = 40
WRITTEN_PER_KEYPOINT = 4 + 256


def covered_bytes(stacked, level, y0, x0) -> int:
    """Bytes of the pyramid [L, H, W] the patches at the clamped origins
    cover, each pixel counted once."""
    L, H, W = stacked.shape
    lv = level.long().clamp(0, L - 1)
    y = y0.long().clamp(0, H - PATCH)
    x = x0.long().clamp(0, W - PATCH)
    r = torch.arange(PATCH, device=stacked.device)
    seen = torch.zeros(stacked.shape, dtype=torch.bool, device=stacked.device)
    seen[lv[:, None, None], (y[:, None] + r)[:, :, None],
         (x[:, None] + r)[:, None, :]] = True
    return int(seen.sum()) * stacked.element_size()


def stage_bytes(stacked, level, y0, x0) -> int:
    """Pyramid bytes covered plus bytes written, for one frame's call."""
    return (covered_bytes(stacked, level, y0, x0)
            + level.numel() * WRITTEN_PER_KEYPOINT)


@contextlib.contextmanager
def counting():
    """Within the block, every describe call of the reference's frontend
    adds its ``stage_bytes`` to the yielded list."""
    from slambench.reference.frontend import orb

    seen = []
    plain = orb.describe_keypoints

    def counted(stacked, level, y0, x0, radius=15):
        seen.append(stage_bytes(stacked, level, y0, x0))
        return plain(stacked, level, y0, x0, radius)

    orb.describe_keypoints = counted
    try:
        yield seen
    finally:
        orb.describe_keypoints = plain


def frame_bytes(cfg, intr, rgb, depth, mask) -> int:
    """The describe stage's bytes for one frame (device tensors), through
    the reference's frontend with the configuration ``cfg``."""
    from slambench.reference.pipeline import extract_frame

    with counting() as seen:
        extract_frame(rgb, depth, mask, intr, cfg)
    return sum(seen)
