"""Profiling utilities (SURVEY §5.1): stage wall-clock spans like the
reference's chrono prints around BA setup/solve (Optimizers.cpp:194-220),
plus a torch.profiler trace context for full device timelines.

``StageTimer`` is a copy of the one in kbslam/utils/profiling.py.
``device_trace`` is the port's counterpart of the reference package's
``jax.profiler`` context: a ``torch.profiler.profile`` whose activities
follow the device it is given (the CPU's and the card's kernels for a
CUDA device, the CPU's alone for ``"cpu"``), written as one Chrome trace
(``trace.json``, readable in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List


class StageTimer:
    """Accumulates wall-clock spans per named stage."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.spans.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = dict(
                count=n,
                total_ms=sum(xs) * 1e3,
                mean_ms=sum(xs) / n * 1e3,
                p50_ms=xs_sorted[n // 2] * 1e3,
                max_ms=xs_sorted[-1] * 1e3,
            )
        return out

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>6s} {'mean ms':>9s} {'p50 ms':>9s} {'max ms':>9s}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} {s['count']:6d} {s['mean_ms']:9.2f} "
                f"{s['p50_ms']:9.2f} {s['max_ms']:9.2f}")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir=None, device=None):
    """torch.profiler trace of the block: yields ``log_dir`` (a fresh
    temporary directory when None) and writes ``log_dir/trace.json`` on
    exit. ``device`` picks the activities, like the port's entry points:
    the CUDA device when None (raising when there is none), the CPU only
    when named."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.device import pick_device

    dev = pick_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="kbslam_trace_")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
