"""Device selection, float32 matmul precision, host uploads and CUDA
graph capture and replay (``graph_capture``, ``replay``):
``CapturedCall`` (one call captured over static inputs), ``LiveGraphs``
(a program replayed on the tensors it was captured on), ``Replayed``
(one captured call per argument shapes, from the second call with them)
and ``Programs`` (a shell's named programs, with the static tensors
they read).

The port runs on the card: without a device name, ``pick_device``
returns the current CUDA device and raises when there is none. The CPU
is used only when the caller names it (the tests do).

The JAX tracking step runs under ``jax.default_matmul_precision
("highest")`` (kbslam/pipeline.py:153-158): the DLT normal matrices,
Kabsch and the Gauss-Newton solves need true float32 products. The
torch counterpart is to keep TF32 off for matmuls and for cuDNN.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Optional, Union

import numpy as np
import torch

from kbslam_torch.utils import profiling


def pick_device(name: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device the port runs on: ``name`` when given, else the
    current CUDA device; raises when a CUDA device is asked for and there
    is none. Also sets full float32 precision (see module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kbslam_torch runs on a CUDA device and found none; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if name is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload_into(dst: torch.Tensor, array) -> torch.Tensor:
    """Copy the host ``array`` into the device tensor ``dst`` in place;
    returns ``dst``. On CUDA the copy goes through a fresh pinned buffer
    and is asynchronous, so it makes no host sync; PyTorch's
    pinned-memory cache keeps the buffer until the copy has run."""
    t = torch.from_numpy(np.array(array)).to(dst.dtype).reshape(dst.shape)
    if dst.is_cuda:
        t = t.pin_memory()
    return dst.copy_(t, non_blocking=dst.is_cuda)


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph",
                  stream: Optional["torch.cuda.Stream"] = None, pool=None,
                  name: Optional[str] = None):
    """``torch.cuda.graph(graph, stream=stream)`` with Python's garbage
    collector run before the capture and switched off during it. A dead
    reference cycle that holds another CUDA graph would otherwise be
    collected at some allocation inside the capture; freeing that graph
    there is an operation a capturing stream does not permit, and the
    capture fails. ``stream`` (default: torch's one capture stream) also
    picks the cuBLAS workspace the graph bakes in, which torch keeps per
    stream: graphs that replay at the same time need streams of their
    own. ``pool`` is a memory pool shared with other graphs (see
    ``LiveGraphs``).

    Every graph gets its stage marks here (``utils.profiling``): a mark
    first and last, and each ``profiling.mark`` its function reaches, in
    ``graph.marks`` (a ``profiling.Marks`` named ``name``), which
    ``replay`` reads."""
    dev = (stream.device if stream is not None
           else torch.device("cuda", torch.cuda.current_device()))
    graph.marks = profiling.Marks(name or "graph", dev)
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            with profiling.capturing(graph.marks):
                yield
    finally:
        if was_enabled:
            gc.enable()


def replay(graph: "torch.cuda.CUDAGraph") -> None:
    """Replay a graph of ``graph_capture`` on the current stream; with the
    recorder on, queue a copy of its stage marks after it."""
    graph.replay()
    graph.marks.read()


def tensor_leaves(tree):
    """The tensors of nested tuples (NamedTuples included), in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from tensor_leaves(x)


class CapturedCall:
    """``fn(*args)`` captured as one CUDA graph over static copies of its
    arguments (tensors, or nested tuples of them).

    A call copies its arguments into the static inputs on the current
    stream, replays the graph and returns ``fn``'s outputs, which live in
    the graph's memory until the next call: read or copy them first. The
    capture follows a warm-up on a side stream (library handles, caches);
    ``fn`` must make no host sync, and a capture that fails raises.

    With ``live=True`` the graph reads and writes the tensors of ``args``
    themselves, which must then stay where they are between calls (the
    port's counterpart of the reference's donated arguments); the
    warm-up runs on copies, so they are untouched until the first call,
    and a call takes no arguments. ``stream`` is the stream of the
    warm-up and the capture (default: a new one for the warm-up and
    torch's capture stream), ``pool`` a memory pool shared with other
    graphs. ``warm=False`` leaves the warm-up out, where the caller has
    just run ``fn`` eagerly at these shapes on this device. ``name``
    names the graph's stage marks (``graph_capture``)."""

    def __init__(self, fn, *args, live: bool = False, stream=None,
                 pool=None, warm: bool = True, name: Optional[str] = None):
        self.inputs = args if live else _clone(args)
        if warm:
            dev = next(tensor_leaves(args)).device
            cur = torch.cuda.current_stream(dev)
            side = stream if stream is not None else torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn(*(_clone(args) if live else self.inputs))
            cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph, stream=stream, pool=pool, name=name):
            self.outputs = fn(*self.inputs)

    def load(self, *args):
        """Copy ``args`` into the static inputs on the current stream."""
        for dst, src in zip(tensor_leaves(self.inputs), tensor_leaves(args)):
            dst.copy_(src)

    def __call__(self, *args):
        self.load(*args)
        replay(self.graph)
        return self.outputs


# replays and captures of every named LiveGraphs in the process, by name
replays: collections.Counter = collections.Counter()
captures: collections.Counter = collections.Counter()


def reset_counts() -> None:
    replays.clear()
    captures.clear()


class LiveGraphs:
    """``fn(*args)`` on CUDA as one CUDA graph per set of argument tensors,
    captured on those tensors at their first call (``CapturedCall`` with
    ``live=True``) and replayed on the current stream after: the port's
    counterpart of a jitted program with donated arguments. ``fn`` writes
    its results into its argument tensors in place (``assign_state``)
    and may return more tensors, which live in the graph's memory until
    its next replay.

    A set of tensors is told apart by their addresses, shapes, strides
    and dtypes; whatever else ``fn`` reads on the host is baked into the
    graph at its capture, so what changes from call to call is loaded
    into a static device tensor first (a ring slot, an id). Every graph
    is captured on ``stream`` (the cuBLAS workspace a graph bakes in is
    its capture stream's, so graphs that may replay beside another
    program's need a stream of their own) and in ``pool``: graphs that
    never replay at the same time, whose outputs are read before another
    replays, may share one. A CPU tensor raises ``ValueError``: the
    caller runs ``fn`` itself there. A capture that fails raises.

    ``replays`` counts the replays, ``capture_s`` holds each capture's
    host seconds (warm-up and capture); with a ``name``, the module's
    ``replays`` and ``captures`` count them too, by that name."""

    def __init__(self, fn, stream=None, pool=None, name=None):
        self.fn, self.stream, self.pool, self.name = fn, stream, pool, name
        self.graphs: dict = {}
        self.replays = 0
        self.capture_s: list = []

    def __call__(self, *args):
        leaves = list(tensor_leaves(args))
        if not all(t.is_cuda for t in leaves):
            raise ValueError("LiveGraphs replays on CUDA tensors only")
        k = tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for t in leaves)
        g = self.graphs.get(k)
        if g is None:
            t0 = time.perf_counter()
            g = self.graphs[k] = CapturedCall(self.fn, *args, live=True,
                                              stream=self.stream,
                                              pool=self.pool, name=self.name)
            self.capture_s.append(time.perf_counter() - t0)
            captures[self.name] += 1
        replay(g.graph)
        self.replays += 1
        replays[self.name] += 1
        return g.outputs


_WARMED = object()     # a Replayed shape run once, eagerly


class Replayed:
    """``fn(*args)`` on CUDA as one CUDA graph per set of argument shapes
    and dtypes: the port's counterpart of a jitted function, which keeps
    one executable per shape. The first call with those shapes runs
    ``fn`` eagerly, and that run is the warm-up (library handles, caches,
    an NCCL communicator's first collective); the second captures ``fn``
    (``CapturedCall`` over static copies of the arguments, no warm-up of
    its own) and replays it, and later calls replay. A shape called once
    thus costs what the eager call does, and one called again pays the
    capture once. The graphs are shared by every instance with the same
    ``key``, which names the settings ``fn`` was made with (whatever it
    bakes in besides its arguments), and kept for the life of the
    process; ``cache``, when given, is the dict that keeps them instead
    (a process group's ``graphs``, which must not outlive the group). A
    replay returns ``fn``'s outputs in the graph's memory, rewritten by
    the next call with those shapes: read or copy them first. A CPU
    tensor raises ``ValueError``: the caller runs ``fn`` itself there. A
    capture that fails raises. With a ``name``, the module's ``replays``
    and ``captures`` count the replays and captures by it."""

    _graphs: dict = {}

    def __init__(self, fn, key, name=None, cache=None):
        self.fn, self.key, self.name = fn, key, name
        self._cache = self._graphs if cache is None else cache

    def __call__(self, *args):
        leaves = list(tensor_leaves(args))
        if not all(t.is_cuda for t in leaves):
            raise ValueError("Replayed replays on CUDA tensors only")
        k = (self.key, leaves[0].device,
             tuple((t.shape, t.dtype) for t in leaves))
        call = self._cache.get(k)
        if call is None:            # the first call: eager, the warm-up
            self._cache[k] = _WARMED
            return self.fn(*args)
        if call is _WARMED:
            call = self._cache[k] = CapturedCall(self.fn, *args, warm=False,
                                                 name=self.name)
            captures[self.name] += 1
        replays[self.name] += 1
        return call(*args)


class Programs:
    """A shell's programs (``slam.SLAM``, ``streaming.ChunkedStream``):
    on CUDA, ``program`` makes each a ``LiveGraphs`` (``graphs[name]``),
    captured on the shell's own stream, whose cuBLAS workspace no
    concurrent graph bakes in, and in the shell's one memory pool (a
    program's outputs are read before another replays); on the CPU, or
    with ``graphed=False``, it returns the plain function. ``load`` keeps
    the static device tensors the graphs read, one per (name, shape,
    dtype); ``statics`` holds them."""

    def __init__(self, device: torch.device, graphed: bool = True):
        self.device = device
        self.graphs: dict = {}
        self.statics: dict = {}
        self.graphed = graphed and device.type == "cuda"
        if self.graphed:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()

    def program(self, name: str, fn):
        """``fn`` as the shell calls it: replayed as CUDA graphs on CUDA,
        the function itself otherwise."""
        if not self.graphed:
            return fn
        g = self.graphs[name] = LiveGraphs(fn, stream=self.stream,
                                           pool=self.pool, name=name)
        return g

    def static(self, name: str, shape, dtype=torch.float32) -> torch.Tensor:
        """The static device tensor ``name``: one per name, shape and
        dtype, kept across calls (the graphs read it)."""
        k = (name, tuple(shape), dtype)
        buf = self.statics.get(k)
        if buf is None:
            buf = self.statics[k] = torch.empty(shape, dtype=dtype,
                                                device=self.device)
        return buf

    def load(self, name: str, array, dtype=torch.float32) -> torch.Tensor:
        """The static tensor ``name`` with the host ``array`` copied in
        (``upload_into``), or filled with it when it is a scalar."""
        a = np.asarray(array)
        buf = self.static(name, a.shape, dtype)
        if a.ndim == 0:
            return buf.fill_(a.item())
        return upload_into(buf, a)


def assign_state(dst, src):
    """Copy ``src`` into ``dst``'s tensors, in place, for two states (or
    maps, or any two tuples of tensors) of one layout; a field that is
    already the same tensor is skipped. Raises ``ValueError`` where a
    shape or dtype differs. Returns ``dst``."""
    pairs = list(zip(tensor_leaves(dst), tensor_leaves(src)))
    for d, s in pairs:
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"assign_state: {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
    for d, s in pairs:
        if d.data_ptr() != s.data_ptr() or d.stride() != s.stride():
            d.copy_(s)
    return dst


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_clone(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
