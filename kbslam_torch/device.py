"""Device selection, float32 matmul precision and CUDA graph capture.

The port runs on the card: without a device name, ``pick_device``
returns the current CUDA device and raises when there is none. The CPU
is used only when the caller names it (the tests do).

The JAX tracking step runs under ``jax.default_matmul_precision
("highest")`` (kbslam/pipeline.py:153-158): the DLT normal matrices,
Kabsch and the Gauss-Newton solves need true float32 products. The
torch counterpart is to keep TF32 off for matmuls and for cuDNN.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Optional, Union

import torch


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


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph"):
    """``torch.cuda.graph(graph)`` with Python's garbage collector run
    before the capture and switched off during it. A dead reference cycle
    that holds another CUDA graph would otherwise be collected at some
    allocation inside the capture; freeing that graph there is an
    operation a capturing stream does not permit, and the capture fails.
    """
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if was_enabled:
            gc.enable()


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
    ``fn`` must make no host sync, and a capture that fails raises."""

    def __init__(self, fn, *args):
        self.inputs = _clone(args)
        dev = next(tensor_leaves(args)).device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(*self.inputs)
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph):
            self.outputs = fn(*self.inputs)

    def load(self, *args):
        """Copy ``args`` into the static inputs on the current stream."""
        for dst, src in zip(tensor_leaves(self.inputs), tensor_leaves(args)):
            dst.copy_(src)

    def __call__(self, *args):
        self.load(*args)
        self.graph.replay()
        return self.outputs


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_clone(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree
