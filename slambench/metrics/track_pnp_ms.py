"""``track_pnp_ms``: device ms of the ``pnp`` stage (PnP-RANSAC, its
polish and the inlier ratio) in a replay of the shell's tracking graph,
by its stage marks; the median over the traced frames
(``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("track",), "pnp")
