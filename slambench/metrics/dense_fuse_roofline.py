"""``dense_fuse_roofline``: a keyframe's fusion's share of its byte bound:
the bytes it must move (``harness/dense_bytes.fuse_bytes``: one slot's
tsdf and weight read and written once, and the depth image), reckoned by
the driver from the configuration (``layer["dense_fuse_bytes"]``), at
the card's peak bandwidth, over ``dense_fuse_ms``."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "dense_icp_ms")
_ms = manifest.load_module("metrics", "dense_fuse_ms")


def read(layer, records=None):
    return _base.roofline(layer.get("dense_fuse_bytes"),
                          _ms.read(layer, records))
