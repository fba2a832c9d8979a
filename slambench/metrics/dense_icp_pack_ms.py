"""``dense_icp_pack_ms``: device ms of the ``icp_pack`` stage (the [K, V]
repack of the K atlas slots of the ICP window, with the unobserved
sentinel) in a replay of the shell's ICP graph; the median over the
traced replays (``dense_icp_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "dense_icp_ms")


def read(layer, records=None):
    return _base.stage_ms(records, "icp_atlas", "icp_pack")
