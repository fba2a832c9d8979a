"""A bounded stretch of a run under ``torch.profiler``, reduced in memory.

The driver opens a span around each call into the program
(``Tracer.span``: a ``record_function`` named after the span); the
reduction gives every span the device work it caused. A kernel belongs
to the runtime call that launched it (the same correlation id): a
``cudaGraphLaunch`` for every kernel of a replayed graph, a
``cudaLaunchKernel`` or a copy for the rest; the runtime call belongs to
the span whose host interval holds it. So a span's first graph launch is
the first program it replayed, and so on in order.

No Chrome trace is written: a frame runs about ten thousand kernels,
and the reduction keeps only sums.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import List, NamedTuple, Optional

PREFIX = "slambench."
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Launch(NamedTuple):
    """One runtime call that put work on the device, and that work."""

    api: str            # cudaGraphLaunch, cudaLaunchKernel, cudaMemcpyAsync, ...
    start_ns: int
    kernels: list       # [(name, duration ns)]

    @property
    def device_ms(self) -> float:
        """Kernel time, copies and fills left out."""
        return sum(d for n, d in self.kernels if is_kernel(n)) / 1e6

    def count(self) -> int:
        return sum(is_kernel(n) for n, _ in self.kernels)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Span(NamedTuple):
    kind: str
    index: int
    start_ns: int
    end_ns: int
    launches: List[Launch]

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        return sum(x.device_ms for x in self.launches)

    def graph_launches(self) -> List[Launch]:
        return [x for x in self.launches if x.api.startswith("cudaGraphLaunch")]


class Profile(NamedTuple):
    spans: List[Span]
    busy_s: float           # device time with any operation running
    window_s: float         # the traced stretch, first span start to last end
    device_ops: list        # [(kernel name, seconds)], the longest first
    idle_gaps: list         # [(what the host did, seconds)], the longest first

    def fields(self) -> dict:
        """What the result line takes from the profile: ``busy_s``,
        ``window_s`` and the breakdown."""
        return dict(busy_s=self.busy_s, window_s=self.window_s,
                    breakdown={"device_ops": [list(x) for x in self.device_ops],
                               "idle_gaps": [list(x) for x in self.idle_gaps]})


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def _is_device(e) -> bool:
    kind = _kind(e)
    if kind:
        return any(k in kind for k in _DEVICE_KINDS)
    return "CUDA" in str(e.device_type())


def _short(name: str, n: int = 40) -> str:
    """A kernel name without its template arguments, at most n letters."""
    name = name.replace("void ", "")
    cut = name.find("<")
    return (name[:cut] if cut > 0 else name)[:n]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, top: int = 10) -> Profile:
    """The spans, the device's busy share and the breakdown of a list of
    kineto events (``prof.profiler.kineto_results.events()``)."""
    host, device, spans = [], [], []
    for e in events:
        name = e.name()
        if name.startswith(PREFIX):
            # a span; its mirror on the device timeline is no work
            if _is_device(e):
                continue
            kind, _, idx = name[len(PREFIX):].rpartition(".")
            spans.append([kind, int(idx), e.start_ns(),
                          e.start_ns() + e.duration_ns(), []])
        elif _is_device(e):
            device.append(e)
        else:
            host.append(e)
    spans.sort(key=lambda s: s[2])
    starts = [s[2] for s in spans]
    by_corr = {}
    for e in host:
        if _is_launch(e.name()):
            by_corr[e.correlation_id()] = [e.name(), e.start_ns(), []]
    for e in device:
        rec = by_corr.get(e.correlation_id()) or by_corr.get(
            e.linked_correlation_id())
        if rec is not None:
            rec[2].append((e.name(), e.duration_ns()))
    for api, start, kernels in sorted(by_corr.values(), key=lambda r: r[1]):
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start <= spans[i][3]:
            spans[i][4].append(Launch(api, start, kernels))
    spans = [Span(k, i, s, e, ls) for k, i, s, e, ls in spans]
    if not spans:
        return Profile([], 0.0, 0.0, [], [])
    w0, w1 = spans[0].start_ns, spans[-1].end_ns
    busy = _union((max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(),
                                              w1))
                  for e in device if e.start_ns() < w1
                  and e.start_ns() + e.duration_ns() > w0)
    busy_ns = sum(e - s for s, e in busy)
    totals = {}
    for e in device:
        totals[_short(e.name())] = totals.get(_short(e.name()), 0) + e.duration_ns()
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_activity(host, spans, (s + e) // 2), (e - s) / 1e9)
             for s, e in gaps[:top]]
    return Profile(spans, busy_ns / 1e9, (w1 - w0) / 1e9,
                   [(n, d / 1e9) for n, d in ops], named)


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaGraphLaunch", "cudaLaunchKernel",
                            "cudaMemcpy", "cudaMemset", "cuLaunchKernel",
                            "cudaLaunchCooperativeKernel"))


def _host_activity(host, spans, t: int) -> str:
    """What the host did at ``t``: the shortest host event holding it,
    within its span's kind."""
    best = None
    for e in host:
        s = e.start_ns()
        if s <= t <= s + e.duration_ns() and (
                best is None or e.duration_ns() < best.duration_ns()):
            best = e
    kind = next((sp.kind for sp in spans if sp.start_ns <= t <= sp.end_ns),
                "between spans")
    return f"{kind}: {_short(best.name(), 28) if best is not None else 'python'}"


class Tracer:
    """``torch.profiler`` over a stretch, and the spans the driver opens.

    Off (``enabled=False``) ``span`` does nothing, so an untraced run
    pays nothing for it. On, the profiler is started and stopped once at
    construction (set-up): its first start on a card takes seconds,
    which would otherwise stall the window."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self._prof = None
        self.profile: Optional[Profile] = None
        if enabled:
            import torch

            self.start()
            torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
            self._prof.__exit__(None, None, None)
            self._prof = None

    def start(self):
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self):
        if self._prof is None:
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.profile = reduce(self._prof.profiler.kineto_results.events())
        self._prof = None

    @contextlib.contextmanager
    def span(self, kind: str, index: int):
        if self._prof is None:
            yield
            return
        from torch.profiler import record_function

        with record_function(f"{PREFIX}{kind}.{index}"):
            yield
