"""One process per device over ``torch.distributed``: the port's
counterpart of the reference's ``jax.sharding`` meshes.

The reference runs one SPMD program over a device mesh (``shard_map``,
``NamedSharding``). The port runs one process per device, joined in a
process group, and maps the mesh's constructs so:

- the mesh axis is the process group (``ShardGroup``);
- ``psum`` is ``ShardGroup.sum`` (all-reduce, SUM);
- ``psum_scatter(tiled=True)`` is ``ShardGroup.sum_scatter``
  (reduce-scatter on dim 0);
- ``all_gather(tiled=True)`` is ``ShardGroup.gather`` (all-gather on
  dim 0);
- ``NamedSharding(P(axis))``: each rank holds its contiguous block of
  the leading axis (``ShardGroup.block``); ``P()``: every rank holds a
  copy.

A group on CUDA devices uses NCCL, one card per rank; a group on the CPU
uses gloo (the tests). There is no gloo-on-CUDA group and no fallback: a
CUDA group without enough cards raises. Code that takes ``group=None``
runs on one device, where every collective is the identity.

``spawn`` starts one process per rank with ``torch.multiprocessing``
(the spawn method), joins them through a ``FileStore`` in a directory
(no TCP port, so many groups can run side by side), runs ``fn(group,
*args)`` on every rank, and returns what each returned. A rank that
raises has its exception raised in the caller; a run that outlasts
``timeout_s`` (a hung collective) is killed and raises ``TimeoutError``.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from kbslam_torch.device import pick_device

# the newer names of the two tiled collectives, where this torch has them
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather")


class ShardGroup:
    """This process's rank in a process group of ``world`` ranks, on
    ``device``, with a count of the collectives it made.

    ``counts[op]`` is [calls, bytes] for each op of ``COLLECTIVES``;
    bytes are those of the whole (unsharded) tensor: the all-reduced
    tensor, the reduce-scatter's input, the all-gather's output.
    A collective made from the host counts; a replay of a CUDA graph
    that holds collectives runs none of this code and counts nothing.

    ``graphs`` keeps the CUDA graphs that hold this group's collectives
    (``device.Replayed`` caches, as ``global_ba.replayed_global_solve``
    makes them): clear it before ``destroy_process_group``, since NCCL
    does not destroy a communicator while a graph of its collectives
    lives (``spawn`` does)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 pg=None):
        self.rank, self.world, self.device, self.pg = rank, world, device, pg
        self.counts: Dict[str, List[int]] = {}
        self.graphs: dict = {}
        self.reset_counts()

    def __repr__(self):
        return (f"ShardGroup(rank={self.rank}, world={self.world}, "
                f"device={self.device})")

    def reset_counts(self):
        self.counts = {op: [0, 0] for op in COLLECTIVES}

    def collectives(self) -> int:
        """Collective calls since the last ``reset_counts``."""
        return sum(c for c, _ in self.counts.values())

    def _count(self, op: str, nbytes: int):
        self.counts[op][0] += 1
        self.counts[op][1] += nbytes

    def rows(self, n: int, what: str):
        """(first, count) of this rank's contiguous block of ``n`` rows;
        raises ``ValueError`` naming ``what`` when ``n`` is not divisible
        by the world size."""
        if n % self.world:
            raise ValueError(f"{what}: {n} rows are not divisible by the "
                             f"{self.world} ranks")
        count = n // self.world
        return self.rank * count, count

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (``psum``), on every rank."""
        out = t.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", out.nbytes)
        dist.all_reduce(out, group=self.pg)
        return out

    def sum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of the sum of ``t`` over the ranks
        (``psum_scatter(scatter_dimension=0, tiled=True)``)."""
        _, rows = self.rows(t.shape[0], "sum_scatter")
        t = t.contiguous()
        out = t.new_empty((rows,) + tuple(t.shape[1:]))
        self._count("reduce_scatter", t.nbytes)
        _reduce_scatter(out, t, group=self.pg)
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of rows stacked in rank order
        (``all_gather(axis=0, tiled=True)``)."""
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * self.world,) + tuple(t.shape[1:]))
        self._count("all_gather", out.nbytes)
        _all_gather(out, t, group=self.pg)
        return out

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of this rank's contiguous block of the leading axis;
        raises ``ValueError`` (before any collective) when the axis is
        not divisible by the world size."""
        first, rows = self.rows(t.shape[0], "block")
        return t[first:first + rows].clone()


def gather_tree(tree, group: ShardGroup):
    """``group.gather`` over every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return group.gather(tree)
    return type(tree)(*(gather_tree(x, group) for x in tree))


def block_tree(tree, group: ShardGroup):
    """``group.block`` over every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return group.block(tree)
    return type(tree)(*(block_tree(x, group) for x in tree))


def _backend(device: torch.device, world: int) -> str:
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process group for device {device}")
    if torch.cuda.device_count() < world:
        raise RuntimeError(
            f"a CUDA group of {world} ranks needs {world} CUDA devices, one "
            f"per rank; found {torch.cuda.device_count()}")
    return "nccl"


def init_group(device, rank: int, world: int, store,
               timeout_s: float = 300.0) -> ShardGroup:
    """Join the default process group as ``rank`` of ``world`` through
    ``store`` (a ``torch.distributed`` store): NCCL on CUDA, with rank r
    on card r; gloo on the CPU. Raises when a CUDA group has fewer cards
    than ranks. The rank's device is set up as ``device.pick_device``
    sets one up (full float32 matmul precision)."""
    dev = torch.device(device)
    backend = _backend(dev, world)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dev = pick_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ShardGroup(rank, world, dev, dist.group.WORLD)


def _run_rank(fn, rank, world, device, store_path, timeout_s, args, results):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        group = init_group(device, rank, world, store, timeout_s)
        try:
            out = fn(group, *args)
            dist.barrier()
        finally:
            group.graphs.clear()
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException as e:  # reported to the parent, which re-raises
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((e, tb))
        except Exception:  # an exception that does not pickle
            payload = pickle.dumps((RuntimeError(repr(e)), tb))
        results.put((rank, False, payload))


def spawn(fn: Callable, world: int, device, args: Sequence[Any] = (),
          timeout_s: float = 300.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(group, *args)`` in ``world`` new processes, one per rank,
    joined in one group on ``device`` (``"cpu"``: gloo; ``"cuda"``: NCCL,
    rank r on card r), and return the list of what each rank returned.

    ``fn`` is pickled by reference, so it lives at the top of an
    importable module; ``args`` and the results travel by pickle, so pass
    and return host data (numpy arrays travel by value). A CPU rank runs
    on one thread. The group's ``FileStore``
    lives in ``workdir`` (default: a temporary directory, removed after).
    The first rank's exception is raised here, with that rank's traceback
    as a note; past ``timeout_s`` every rank is killed and
    ``TimeoutError`` raised."""
    _backend(torch.device(device), world)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="kbslam_group_") if own else workdir
    store_path = os.path.join(workdir, f"store_{os.getpid()}_{time.time_ns()}")
    procs = [ctx.Process(target=_run_rank,
                         args=(fn, r, world, str(device), store_path,
                               timeout_s, tuple(args), results))
             for r in range(world)]
    got: Dict[int, Any] = {}
    ok = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{fn.__name__} on {world} ranks did not end within "
                    f"{timeout_s} s (ranks done: {sorted(got)})")
            try:
                rank, fine, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                lost = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if lost and results.empty():
                    raise RuntimeError(
                        f"rank {lost[0]} of {fn.__name__} exited with code "
                        f"{procs[lost[0]].exitcode} and reported nothing")
                continue
            if not fine:
                exc, tb = pickle.loads(payload)
                exc.add_note(f"raised in rank {rank} of {world}:\n{tb}")
                raise exc
            got[rank] = pickle.loads(payload)
        ok = True
    finally:
        for p in procs:
            if p.is_alive() and ok:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    return [got[r] for r in range(world)]
