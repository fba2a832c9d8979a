"""``dense_icp_roofline``: an ICP solve's share of the bytes an ideal
solve moves (``harness/dense_bytes.icp_bytes``: the depth image, and per
fetch the 8 corners' tsdf and weight of each sampled point in each slot
of the window), reckoned by the driver from the configuration
(``layer["dense_icp_bytes"]``), at the card's peak bandwidth, over
``dense_icp_ms``."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "dense_icp_ms")


def read(layer, records=None):
    return _base.roofline(layer.get("dense_icp_bytes"),
                          _base.read(layer, records))
