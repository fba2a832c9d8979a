"""``dense_fuse_ms``: device ms of one replay of the shell's fusion graph
(``SLAM.graphs["submap_fuse"]``: a keyframe's depth into the active
submap), first stage mark to last; the median over the traced keyframes
(``dense_icp_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "dense_icp_ms")


def read(layer, records=None):
    return _base.graph_ms(records, "submap_fuse", ("fuse",))
