"""``track_frontend_ms``: device ms of the ``frontend`` stage (the step's
first mark to the end of ``extract_frame``) in a replay of the shell's
tracking graph (``SLAM.graphs["track"]``), read from the program's stage
marks inside the graph; the median over the traced frames.

The program's readers (``program_span``, ``program_counter``) take their
records and helpers from this file: the records of
``kbslam_torch.utils.profiling``, which the recorder kept while the
traced stretch's profiler ran. A program without that recorder gives
none, and each reader then returns None."""
from slambench.harness.report import median


def program_records(records=None) -> list:
    """``records`` when given (tests fill them by hand), else the
    program's."""
    if records is not None:
        return records
    try:
        from kbslam_torch.utils.profiling import records as kept
    except ImportError:
        return []
    return kept()


def stage_ms(records, graphs, stage):
    """The median device ms of ``stage`` over every step of the replays of
    the graphs named in ``graphs``; None where there is none."""
    v = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in program_records(records)
         if r["kind"] == "stage" and r["name"] == stage
         and r["graph"] in graphs and r["clock"] == "device"]
    return median(v) if v else None


def read(layer, records=None):
    return stage_ms(records, ("track",), "frontend")
