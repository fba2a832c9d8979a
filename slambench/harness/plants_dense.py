"""Faults of the dense model planted in the program at run time, never in
its files: the faults ``drivers/replay.py``'s check has to catch (the
tests plant them on the CPU, ``control_dense.py --plant`` on the card).

Each plant takes a ``setattr(obj, name, value)`` and must be planted
before the driver builds the program, so that the captured graphs hold
it (``harness/plants.py``).
"""
from __future__ import annotations


def fuse_wrong_slot(setattr):
    """A keyframe is fused into the ring slot before the active submap's."""
    import torch

    import kbslam_torch.mapping.submap as submap

    real = submap.make_submap_ops

    def make(cfg, intr, num_submaps, depth_scale=1.0):
        start, fuse = real(cfg, intr, num_submaps, depth_scale)

        def wrong(atlas, depth_raw, q, t, anchor_q, anchor_t, slot=None):
            idx = submap.slot_index(atlas, atlas.active_slot()
                                    if slot is None else slot)
            prev = torch.remainder(idx - 1, atlas.capacity)
            return fuse(atlas, depth_raw, q, t, anchor_q, anchor_t, prev)
        return start, wrong
    setattr(submap, "make_submap_ops", make)


def icp_dropped(setattr):
    """The ICP refine runs, its result is read and gated, but an accepted
    pose is not applied: the frame returns the step's pose."""
    import kbslam_torch.slam as slam

    real = slam.SLAM._icp_tick

    def dropped(self, o, depth_dev):
        out = real(self, o, depth_dev)
        if o["success"]:
            return dict(out, pose_q=o["pose_q"], pose_t=o["pose_t"])
        return out
    setattr(slam.SLAM, "_icp_tick", dropped)


PLANTS = {"fuse-wrong-slot": fuse_wrong_slot, "icp-dropped": icp_dropped}
