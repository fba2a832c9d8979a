"""The port's recorder (host spans, counters and device stage marks, kept
in memory and written out on request), ``device_trace`` (a torch.profiler
Chrome trace of a block) and ``sync_sites`` (the host syncs of a call).

**On or off.** The recorder is on after ``enable()`` and while a torch
profiler runs (``torch.profiler.profile`` sets the autograd profiler's
flag), so a profiled stretch records with no other switch. Off, ``span``
returns one shared null context and ``count`` and ``mark`` return at
once. The process has one recorder and is expected to drive it from one
thread.

**Spans.** ``span(name, frame=None)`` records a host interval
(``perf_counter_ns``), the span it opened inside and the shell's frame id:
the shell gives it on its outermost span (``SLAM``'s frame, the chunk's
index, the multistream step) and inner spans, counters and stage marks
inherit it. Under a profiler a span also opens a host range
``kbslam.<name>``, so the trace shows it beside the kernels it launched.

**Counters.** ``count(name, n=1)``, at the site where the work happens.

**Stage marks.** ``mark(stage, like)`` ends the stage ``stage`` (``None``
begins a sequence) of work on ``like``'s device; a stage runs from the
mark before it to its own.

- Inside a CUDA graph captured by ``device.graph_capture``, the capture's
  ``Marks`` takes the next slot: a one-thread kernel (``csrc/mark.cu``)
  writes the device's ``%globaltimer`` there on every replay, so a stage's
  time is elapsed device time, gaps between kernels included. Every such
  graph has a first and a last mark besides, and keeps them whether the
  recorder is on or off. When it is on at a replay, ``Marks.read`` queues
  a copy of the slots into pinned memory on the stream, followed by an
  event; the copy is read once that event has completed (``drain``, never
  blocking), or on request (``records``, which waits). No host sync is
  added.
- Eagerly on the CPU, when on: the host clock (the work is synchronous).
- Eagerly on CUDA: nothing (the shell marks its uploads with a ``Marks``
  of its own).

**Records** are dicts, the newest ``KEEP`` per kind and name:

- ``span``: ``name``, ``start_ns``, ``end_ns``, ``parent`` (the ``id`` of
  the span it opened inside, or None), ``frame``;
- ``count``: ``name``, ``n``, ``frame``;
- ``marks``: one read of a ``Marks``: ``name`` (the graph's), its first
  and last readings ``start_ns`` and ``end_ns``, ``frame``, ``clock``;
- ``stage``: ``name``, ``graph`` (its ``Marks``'s name; None for a host
  mark), ``step`` (the how-manyth of its name in that read), ``start_ns``,
  ``end_ns``, ``frame``, ``clock`` (``"device"``: ``%globaltimer``;
  ``"host"``: ``perf_counter_ns``).

Each has an ``id``, in the order it was made (a span's when it opened).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

KEEP = 65536            # records kept per kind and name
MARK_SLOTS = 1024       # slots of a graph's mark buffer
SPAN_PREFIX = "kbslam."
_NULL = contextlib.nullcontext()


def _launch_mark(buf: torch.Tensor, i: int) -> None:
    """The marker kernel into slot ``i`` of ``buf`` on the current
    stream."""
    from kbslam_torch.ops._build import build

    if not 0 <= i < buf.shape[0]:
        raise IndexError(f"mark slot {i} of {buf.shape[0]}")
    lib = build().lib
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.kbslam_stage_mark(buf.data_ptr(), i, stream)
    if err != 0:
        msg = lib.kbslam_cuda_error_string(err).decode()
        raise RuntimeError(f"stage mark kernel launch failed: {msg}")


class Marks:
    """The stage marks of one CUDA graph, or of an eager sequence on the
    card: a device buffer of int64 ``%globaltimer`` readings, one slot per
    mark, and each slot's stage (None where a sequence begins or ends)."""

    def __init__(self, name: str, device, slots: int = MARK_SLOTS):
        self.name = name
        self.labels: list = []
        self.buf = torch.zeros(slots, dtype=torch.int64, device=device)
        # the first launch loads the kernel, which a capture must not do
        _launch_mark(self.buf, slots - 1)

    def add(self, stage) -> None:
        """A mark in the next slot, on the current stream."""
        _launch_mark(self.buf, len(self.labels))
        self.labels.append(stage)

    def read(self, frame=None) -> None:
        """When the recorder is on, queue a copy of the slots marked so far
        (after the work queued on the current stream) for the recorder."""
        _REC.queue(self, frame)


class _Span:
    __slots__ = ("rec", "name", "frame", "id", "parent", "start", "rf")

    def __init__(self, rec, name, frame):
        self.rec, self.name, self.frame = rec, name, frame

    def __enter__(self):
        rec = self.rec
        up = rec._stack[-1] if rec._stack else None
        if self.frame is None and up is not None:
            self.frame = up.frame
        self.parent = None if up is None else up.id
        self.id = next(rec._ids)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            # an operator's range on the host: the profiler mirrors a
            # user annotation (``record_function``) onto the device's
            # timeline, where a reader of the trace would count it as work
            self.rf = torch._C._profiler._RecordFunctionFast(
                SPAN_PREFIX + self.name)
            self.rf.__enter__()
        rec._stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._add(dict(kind="span", name=self.name, start_ns=self.start,
                           end_ns=end, parent=self.parent, frame=self.frame,
                           id=self.id))
        return False


class Recorder:
    """Spans, counters and stage marks in memory (see the module
    docstring); the module's functions are those of one instance."""

    def __init__(self):
        self.on = False
        self._records: dict = {}
        self._ids = itertools.count()
        self._stack: list = []
        self._pending = collections.deque()
        self._capture = None      # the Marks of the capture under way
        self._host_ns = None      # the last host mark

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def enabled(self) -> bool:
        return self.on or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, frame=None):
        if not self.enabled():
            return _NULL
        return _Span(self, name, frame)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled():
            return
        self._add(dict(kind="count", name=name, n=n, frame=self._frame()))

    def mark(self, stage, like: torch.Tensor) -> None:
        if self._capture is not None:
            self._capture.add(stage)
            return
        if like.is_cuda or not self.enabled():
            return
        now = time.perf_counter_ns()
        if stage is not None and self._host_ns is not None:
            self._add(dict(kind="stage", name=stage, graph=None, step=0,
                           start_ns=self._host_ns, end_ns=now,
                           frame=self._frame(), clock="host"))
        self._host_ns = now

    @contextlib.contextmanager
    def capturing(self, marks: Marks):
        """Inside a CUDA graph capture: ``marks`` takes the capture's
        first mark, every ``mark`` made in the block and, when the block
        ends without an error, the last."""
        marks.add(None)
        self._capture = marks
        try:
            yield
        finally:
            self._capture = None
        marks.add(None)

    def queue(self, marks: Marks, frame=None) -> None:
        if not self.enabled() or not marks.labels:
            return
        self.drain()
        n = len(marks.labels)
        host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        host.copy_(marks.buf[:n], non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(marks.buf.device))
        self._pending.append((marks.name, tuple(marks.labels), host, done,
                              self._frame(frame)))

    def drain(self, block: bool = False) -> None:
        """Turn the queued copies of marks into records, in order, up to
        the first whose copy has not completed (``block``: wait for each)."""
        while self._pending:
            name, labels, host, done, frame = self._pending[0]
            if block:
                done.synchronize()
            elif not done.query():
                return
            self._pending.popleft()
            t = host.tolist()
            self._add(dict(kind="marks", name=name, start_ns=t[0],
                           end_ns=t[-1], frame=frame, clock="device"))
            steps = collections.Counter()
            for i in range(1, len(t)):
                stage = labels[i]
                if stage is not None:
                    self._add(dict(kind="stage", name=stage, graph=name,
                                   step=steps[stage], start_ns=t[i - 1],
                                   end_ns=t[i], frame=frame, clock="device"))
                    steps[stage] += 1

    def records(self) -> list:
        """Every record kept, in the order made; waits for the marks still
        being copied."""
        self.drain(block=True)
        return sorted((r for q in self._records.values() for r in q),
                      key=lambda r: r["id"])

    def summary(self) -> dict:
        """{(kind, name): count, total, p50 and max} over the records: ms
        of spans, stages (named ``graph:stage``) and marks, the ``n`` of
        counters."""
        values: dict = {}
        for r in self.records():
            kind, name = r["kind"], r["name"]
            if kind == "stage" and r["graph"] is not None:
                name = f"{r['graph']}:{name}"
            v = (r["n"] if kind == "count"
                 else (r["end_ns"] - r["start_ns"]) / 1e6)
            values.setdefault((kind, name), []).append(v)
        out = {}
        for key, v in sorted(values.items()):
            s = sorted(v)
            out[key] = dict(count=len(s), total=sum(s), p50=s[len(s) // 2],
                            max=s[-1])
        return out

    def report(self) -> str:
        """``summary`` as a table (ms, or the counters' n)."""
        lines = [f"{'kind':6s} {'name':28s} {'count':>7s} {'total':>12s} "
                 f"{'p50':>10s} {'max':>10s}"]
        for (kind, name), s in self.summary().items():
            lines.append(f"{kind:6s} {name:28s} {s['count']:7d} "
                         f"{s['total']:12.3f} {s['p50']:10.3f} "
                         f"{s['max']:10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Forget every record and queued copy."""
        self._records.clear()
        self._pending.clear()
        self._host_ns = None

    def _frame(self, frame=None):
        if frame is None and self._stack:
            return self._stack[-1].frame
        return frame

    def _add(self, rec: dict) -> None:
        if "id" not in rec:
            rec["id"] = next(self._ids)
        key = (rec["kind"], rec["name"], rec.get("graph"))
        q = self._records.get(key)
        if q is None:
            q = self._records[key] = collections.deque(maxlen=KEEP)
        q.append(rec)


_REC = Recorder()
enable, disable, enabled = _REC.enable, _REC.disable, _REC.enabled
span, count, mark, capturing = _REC.span, _REC.count, _REC.mark, _REC.capturing
records, summary, report, reset = (_REC.records, _REC.summary, _REC.report,
                                   _REC.reset)


def sync_sites(fn):
    """{file:line: count} of the operations in ``fn()`` that wait for
    the device (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        f"{w.filename.rsplit('kbslam_torch', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir=None, device=None):
    """torch.profiler trace of the block: yields ``log_dir`` (a fresh
    temporary directory when None) and writes ``log_dir/trace.json`` on
    exit. ``device`` picks the activities, like the port's entry points:
    the CUDA device when None (raising when there is none), the CPU only
    when named. The recorder is on inside, and its spans are in the
    trace as ``kbslam.<name>`` ranges."""
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
