"""``dense_icp_ms``: device ms of one replay of the shell's ICP graph
against the submap atlas (``SLAM.graphs["icp_atlas"]``), from its first
stage mark to its last; the median over the traced replays.

The dense readers take their helpers from this file. On the card they
read the program's device marks; where the programs ran eagerly (the
CPU), the host marks of the same stages stand in, so that a recorded
CPU run reads them too. A program without these marks gives nothing,
and each reader then returns None."""
from slambench.harness import manifest
from slambench.harness.report import median

_base = manifest.load_module("metrics", "track_frontend_ms")


def _ms(r) -> float:
    return (r["end_ns"] - r["start_ns"]) / 1e6


def graph_ms(records, graph, stages):
    """The median device ms of a replay of ``graph``, first mark to last;
    without device marks, the median over frames of the host stages
    ``stages`` summed; None where neither ran."""
    recs = _base.program_records(records)
    v = [_ms(r) for r in recs if r["kind"] == "marks" and r["name"] == graph
         and r["clock"] == "device"]
    if v:
        return median(v)
    per = {}
    for r in recs:
        if r["kind"] == "stage" and r["graph"] is None \
                and r["name"] in stages:
            per[r["frame"]] = per.get(r["frame"], 0.0) + _ms(r)
    return median(per.values()) if per else None


def stage_ms(records, graph, stage):
    """The median ms of ``stage`` in replays of ``graph`` (device marks),
    or of its host marks where no graph ran; None where it did not run."""
    recs = [r for r in _base.program_records(records)
            if r["kind"] == "stage" and r["name"] == stage]
    v = [_ms(r) for r in recs if r["graph"] == graph
         and r["clock"] == "device"]
    if not v:
        v = [_ms(r) for r in recs if r["graph"] is None
             and r["clock"] == "host"]
    return median(v) if v else None


def roofline(nbytes, ms):
    """The share (%) of ``ms`` that moving ``nbytes`` at the card's peak
    bandwidth takes; None without either."""
    from slambench.harness.peaks import HBM_BYTES_PER_S

    if not nbytes or not ms:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (ms / 1e3)


def read(layer, records=None):
    return graph_ms(records, "icp_atlas", ("icp_pack", "icp_gn"))
