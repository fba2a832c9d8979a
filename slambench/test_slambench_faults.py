"""Each cell's check turns ``correct`` false when the timed path is
broken underneath, and keeps it true when it is not (CPU, tiny size:
the run skips the look for a card and drives the rest).

Faults planted: a step that returns its state unchanged; an answer
altered where it is produced (5 cm on the pose); and, where there is a
batch, half of it left out (those streams neither tracked nor
answered), or one stream's answers altered. Faults of the map
(``harness/plants.py``): a local BA whose solve is not written back,
and landmarks triangulated wrongly at insertion. The cells run on one
chip, so no exchange between chips can be left out.
"""
from __future__ import annotations

import pytest
import torch

from slambench import tiny
from slambench.harness import plants

SHIFT = 0.05     # metres added to an altered answer's position


def test_sound_runs_are_correct():
    for name in ("desk-live30", "fleet8-recorded", "desk-chunk8-vo"):
        ok, res = tiny.run(tiny.context(name))
        assert ok, (name, res.numbers)


def _live_frozen(monkeypatch):
    import kbslam_torch.slam as slam
    from kbslam_torch.pipeline import TrackOutput, output_rows

    def frozen(step, state, rgb, depth, mask=None):
        _, out = step(state, rgb, depth, mask)
        return output_rows(TrackOutput(*(f[None] for f in out)))
    monkeypatch.setattr(slam, "track_step_into", frozen)


def _live_altered(monkeypatch):
    import kbslam_torch.slam as slam

    real = slam.row_to_fields

    def altered(row):
        o = real(row)
        o["pose_t"] = o["pose_t"] + SHIFT
        return o
    monkeypatch.setattr(slam, "row_to_fields", altered)


def _chunk_frozen(monkeypatch):
    import kbslam_torch.streaming as streaming

    real = streaming.make_chunk_step

    def make(*a, **kw):
        run = real(*a, **kw)

        def frozen(state, *frames):
            _, outs = run(streaming.clone_state(state), *frames)
            return state, outs
        return frozen
    monkeypatch.setattr(streaming, "make_chunk_step", make)


def _chunk_altered(monkeypatch):
    import kbslam_torch.streaming as streaming

    real = streaming.row_to_fields

    def altered(row):
        o = real(row)
        o["pose_t"] = o["pose_t"] + SHIFT
        return o
    monkeypatch.setattr(streaming, "row_to_fields", altered)


def _planted(name):
    return lambda monkeypatch: plants.PLANTS[name](monkeypatch.setattr)


@pytest.mark.parametrize("cell,plant", [
    ("desk-live30", _live_frozen), ("desk-live30", _live_altered),
    ("desk-chunk8-vo", _chunk_frozen), ("desk-chunk8-vo", _chunk_altered),
    ("desk-live30", _planted("ba-dropped")),
    ("desk-live30", _planted("mp-shifted")),
    ("desk-chunk8-vo", _planted("mp-shifted")),
    ("fleet8-recorded", _planted("mp-shifted")),
], ids=["live-state-unchanged", "live-answer-altered",
        "chunk-state-unchanged", "chunk-answer-altered",
        "live-ba-not-written-back", "live-landmarks-shifted",
        "chunk-landmarks-shifted", "fleet-landmarks-shifted"])
def test_a_broken_path_is_not_correct(monkeypatch, cell, plant):
    plant(monkeypatch)
    ok, res = tiny.run(tiny.context(cell))
    assert not ok, res.numbers


def _fleet_factory(fault):
    from kbslam_torch.device import assign_state
    from kbslam_torch.parallel.multistream import make_multistream_step
    from kbslam_torch.pipeline import clone_state

    def factory(cfg, intr, S, seed):
        real = make_multistream_step(cfg, intr, S, seed=seed)

        def step(state, rgb, depth):
            before = clone_state(state)
            new, out = real(state, rgb, depth)
            if fault == "state unchanged":
                assign_state(new, before)
            elif fault == "one stream altered":
                out = out._replace(pose_t=torch.cat(
                    [out.pose_t[:1] + SHIFT, out.pose_t[1:]]))
            elif fault == "half the batch":
                h = S // 2
                for d, b in zip(list(new.map) + list(new[1:]),
                                list(before.map) + list(before[1:])):
                    d[h:] = b[h:]
                out = out._replace(pose_t=torch.cat(
                    [out.pose_t[:h], before.pose_t[h:]]))
            else:
                out = out._replace(pose_t=out.pose_t + SHIFT)
            return new, out
        return step
    return factory


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered", "one stream altered"])
def test_a_broken_fleet_step_is_not_correct(fault):
    ctx = tiny.context("fleet8-recorded")
    if fault == "one stream altered":
        # four streams checked, one of them wrong: the median over every
        # stream-frame stays sound, the worst stream's does not
        ctx = ctx._replace(overrides=dict(ctx.overrides, streams=4))
        ctx.cell.traffic["check"]["streams"] = 4
    ok, res = tiny.run(ctx, step_factory=_fleet_factory(fault))
    assert not ok, res.numbers
    if fault == "one stream altered":
        assert res.numbers["pose_med_mm"] < 1.0, res.numbers


def test_the_async_chunk_check_follows_merged_solves():
    """The chunked driver with the asynchronous solve (the mix PERF.md
    keeps for later): the program's merged solves are copied and held to
    the reference's, and a sound run is correct."""
    ctx = tiny.context("desk-chunk8-vo", seconds=2.0)
    traffic = dict(ctx.cell.traffic, ba_mode="async")
    ctx = ctx._replace(cell=ctx.cell._replace(traffic=traffic))
    ok, res = tiny.run(ctx)
    assert ok, res.numbers
    line = next(x for x in res.info if x.startswith("check:"))
    solves = int(line.split(" solves against")[0].rsplit(" ", 1)[1])
    assert solves > 0, line
