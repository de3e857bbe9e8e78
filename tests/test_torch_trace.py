"""The stamps and spans of the graph route (``ptzjax_torch/_trace.py``) on
the CPU, on ``test_torch_graph.py``'s 24-frame 320 x 180 sequence: inserts
at 8 and 17, a blackout at 14-15 (lost, frame 15 fails to relocalize, 16
recovers).

The stamp kernels and the frame graph need the card
(``tests/test_torch_cuda.py``); here the graph loop runs its frame program
eagerly (``eager_replays``) and each stamp writes ``time.time_ns()`` into the
same stats buffer, which checks the bookkeeping: the stages each branch
stamps and their order, the sums against each frame's span, the branch
counts, the ring of call records and the gaps' host parts.
"""

import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ptzjax_torch import _graphs, _trace
from tests._torch_port import n
from tests.test_torch_graph import FRAMES, eager_replays, seq  # noqa: F401
from tests.test_torch_graph_insert_reloc import Loop, feats  # noqa: F401

torch.set_num_threads(2)

TRACKED = ["frame.start", *(f"track.{s}" for s in ("frontend", "predict", "association", "update", "map", "tail"))]
INSERT = {
    "insert+ba": ["insert+ba.keyframe", "insert+ba.merge", "insert+ba.ba", "insert+ba.tail"],
    "insert": ["insert.keyframe", "insert.merge", "insert.tail"],
}
LOST_STAMPS = ["frame.start", "lost.frontend", "lost.reloc", "lost.tail"]


@pytest.fixture
def ring(monkeypatch):
    """A ring of the test's own in place of the process's."""
    r = _trace.Ring(64)
    monkeypatch.setattr(_trace, "RING", r)
    return r


@pytest.fixture
def stamped(monkeypatch):
    """The names of the stamps written on the host, in order."""
    log = []
    write = _trace._host_stamp

    def spy(s, k, now):
        log.append(_trace.STAMPS[k])
        write(s, k, now)

    monkeypatch.setattr(_trace, "_host_stamp", spy)
    return log


def _expected(infos, insert: str) -> list:
    """Each frame's stamps from the eager route's view of it."""
    out = []
    for event, keyframe in zip(n(infos.event), n(infos.keyframe)):
        if event == 1:
            out.append(LOST_STAMPS + ["frame.end"])
        else:
            out.append(TRACKED + (INSERT[insert] if keyframe else []) + ["frame.end"])
    return out


def _frames(log) -> list:
    """The log split at each frame's first stamp."""
    starts = [i for i, name in enumerate(log) if name == "frame.start"] + [len(log)]
    return [log[a:b] for a, b in zip(starts, starts[1:])]


@pytest.mark.parametrize(
    "kind, cfg", [("redetect", {}), ("redetect", {"online_ba_iters": 0}), ("klt", {}), ("features", {})],
    ids=["redetect", "redetect-no-ba", "klt", "features"],
)
def test_each_branch_stamps_its_stages_in_order(seq, feats, eager_replays, ring, stamped, kind, cfg):
    """Frames 2-23 in one call (the warm-up and capture in the call of
    frame 1 before it): every frame stamps its first boundary, its
    branches' stages in order and its last boundary, as the frame's kind
    says (tracked; tracked and the insert, with or without the windowed
    BA; lost); the call's read, two clock stamps."""
    loop = Loop(seq, feats, kind, "map", graphs=True, **cfg)
    loop.run(1, 2)
    stamped.clear()
    infos = loop.run(2, FRAMES)
    assert stamped[-2:] == ["clock", "clock"] and stamped.count("clock") == 2   # around the call's read
    got = _frames(stamped[:-2])
    assert got == _expected(infos, "insert" if cfg else "insert+ba")
    kinds = {tuple(f) for f in got}
    assert len(kinds) == 3, kinds   # tracked, insert and lost frames all seen


def test_stage_sums_add_up_to_each_frames_span(seq, feats, eager_replays, ring):
    """In one-frame calls each record's stage sums (every stamp but the
    first ends one) add up to its frame's first-to-last span exactly; in a
    call of several frames to the sum of the frames' spans."""
    loop = Loop(seq, feats, "redetect", "map", graphs=True)
    for k in range(1, 12):
        loop.run(k, k + 1)
    loop.run(12, FRAMES)
    records = ring.records()
    assert len(records) == 12 and all(r.launched == r.frames for r in records)
    for r in records:
        spans = [last - first for first, last in zip(r.rows[::2], r.rows[1::2])]
        assert len(spans) == r.frames and all(s > 0 for s in spans)
        assert r.sums[0] == 0 and sum(r.sums) == sum(spans)
        assert all(a <= b for a, b in zip(r.rows, r.rows[1:]))   # frames in order, none overlapping


def test_branch_counts_of_the_records_are_the_graphs_counts(seq, feats, eager_replays, ring):
    """The branch counts each call's read gives its record add up to the
    graph's ``counts``, which are the frame kinds of the infos."""
    loop = Loop(seq, feats, "redetect", "map", graphs=True)
    infos = [loop.run(a, b) for a, b in ((1, 9), (9, 16), (16, FRAMES))]
    total = np.sum([r.counts for r in ring.records()], axis=0).tolist()
    g = loop.graph()
    assert total == [g.counts[b] for b in _graphs.BRANCHES]
    event = np.concatenate([n(i.event) for i in infos])
    keyframe = np.concatenate([n(i.keyframe) for i in infos])
    assert total == [int((event == 1).sum()), int((event == 0).sum()), int(keyframe.sum()), 0]


def test_window_leaves_out_captured_and_profiled_calls(seq, feats, eager_replays, ring):
    """The call that captures the frame graph and a call under a profiler
    session stay in the ring but out of ``window()``, which gives the other
    complete calls, oldest first."""
    loop = Loop(seq, feats, "redetect", "map", graphs=True)
    loop.run(1, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        loop.run(2, 3)
    loop.run(3, 5)
    loop.run(5, 6)
    first, profiled, *rest = ring.records()
    assert first.captured and not first.profiled and profiled.profiled and not profiled.captured
    assert _trace.window(ring) == rest and [r.frames for r in rest] == [2, 1]
    assert all(r.kind == "redetect" and r.host[_trace.ENTRY] < r.host[_trace.RETURN] for r in rest)


def test_ring_stays_bounded(seq, feats, eager_replays, monkeypatch):
    """A ring of four records over seven calls: it holds the last four,
    oldest first, in the records it was made with."""
    small = _trace.Ring(4)
    monkeypatch.setattr(_trace, "RING", small)
    made = list(small.calls)
    loop = Loop(seq, feats, "redetect", "map", graphs=True)
    for k in range(1, 8):
        loop.run(k, k + 1)
    records = small.records()
    assert small.next == 7 and len(records) == 4 and small.calls == made
    assert [id(r) for r in records] == [id(made[k % 4]) for k in range(3, 7)]
    entries = [r.host[_trace.ENTRY] for r in records]
    assert entries == sorted(entries) and _trace.window(small) == records


def test_gaps_put_a_planted_delay_down_to_its_host_part(seq, feats, eager_replays, ring, monkeypatch):
    """A 30-ms sleep planted in the fill of a call's third frame, and one
    between two calls: ``gaps()`` puts the card's time between those frame
    graphs down to "fill" and to "caller" (the caller's own code)."""
    fill = _graphs.TrackGraph._fill
    filled = []

    def slow_fill(self, inputs):
        filled.append(1)
        if len(filled) == 3:
            time.sleep(0.03)
        fill(self, inputs)

    loop = Loop(seq, feats, "redetect", "map", graphs=True)
    loop.run(1, 2)
    monkeypatch.setattr(_graphs.TrackGraph, "_fill", slow_fill)
    loop.run(2, 6)
    time.sleep(0.03)
    loop.run(6, 8)
    got = _trace.gaps(_trace.window(ring))
    assert got["fill"] >= 30e6 and got["caller"] >= 30e6, got
    assert sorted(got, key=got.get)[-2:] in (["fill", "caller"], ["caller", "fill"]), got
    assert set(got) <= {"caller", "copy_in", "load", *_trace.FRAME_PARTS, "finish", "snapshot", "stack"}


def test_stamps_do_nothing_outside_a_frame_graph_branch(seq, feats, ring, stamped):
    """The eager route (and a stamp with no branch running) writes no stamp
    and begins no record."""
    loop = Loop(seq, feats, "redetect", "map", graphs=False)
    loop.run(1, FRAMES)
    _trace.stamp("predict")
    assert stamped == [] and ring.next == 0


def test_a_call_of_more_frames_than_rows_keeps_the_first_rows():
    """Host stamps of ``ROWS`` + 44 frames of two stamps each: the rows of
    the first ``ROWS`` frames kept, the frame count and the sums whole; the
    clock stamp keeps only its time; a record's read moves the rows by the
    clock's offset."""
    stats = _trace.buffer("cpu")
    s = stats.numpy()
    frames = _trace.ROWS + 44
    for f in range(frames):
        _trace._host_stamp(s, _trace.OPEN, 1000 * f)
        _trace._host_stamp(s, _trace.CLOSE, 1000 * f + 7)
    _trace._host_stamp(s, _trace.CLOCK, 10**6)
    assert s[_trace.ROW] == frames and s[_trace.SUM0 + _trace.CLOSE] == 7 * frames and s[_trace.LAST] == 10**6
    assert s[_trace.SUM0 + _trace.CLOCK] == 0
    assert s[_trace.ROW0 + 2 * _trace.ROWS - 1] == 1000 * (_trace.ROWS - 1) + 7
    rec = _trace.Call()
    rec.launched = frames
    rec.read(stats.tolist(), 5)
    assert len(rec.rows) == 2 * _trace.ROWS and rec.rows[:4] == [5, 12, 1005, 1012]


def test_the_cards_stamp_table_is_the_trace_modules():
    """``csrc/graph_cond.cu``'s stamp table and stats layout are
    ``_trace``'s: the same stamps in the same order, each tail counting its
    branch, the first opening the frame's row, "frame.end" closing it and
    "clock" keeping only its time."""
    src = (Path(_trace.__file__).parent / "csrc" / "graph_cond.cu").read_text()
    table = re.findall(r"X\((\w+), (-?\d+), (k\w+)\)", src)
    assert [name for name, _, _ in table] == [s.replace(".", "_").replace("+", "_") for s in _trace.STAMPS]
    assert {k: int(b) for k, (_, b, _) in enumerate(table) if int(b) >= 0} == _trace.TAILS
    roles = [r for _, _, r in table]
    assert roles == ["kOpens"] + ["kEnds"] * (len(_trace.STAMPS) - 3) + ["kCloses", "kClock"]
    layout = dict(re.findall(r"\b(kLast|kRow|kSum0|kRows) = (\d+)", src))
    assert {k: int(v) for k, v in layout.items()} == {
        "kLast": _trace.LAST, "kRow": _trace.ROW, "kSum0": _trace.SUM0, "kRows": _trace.ROWS,
    }


def test_the_clocks_offset_lies_between_its_ageing_bounds(monkeypatch):
    """Pure Python: the offset is the middle of its bounds; each bound
    loosens by ``DRIFT_PPM`` as it ages; a tighter bound replaces it, one
    that crosses the other bound replaces both; ``bound`` takes a launched
    stamp as a lower bound and a read one as an upper bound; a profiler
    session begun since the calibration calibrates anew; the CPU has no
    offset."""
    second, drift = 10**9, _trace.DRIFT_PPM * 1000
    clock = _trace.Clock(100, 200, 0)
    assert clock.offset(0) == 150 and clock.bounds(second) == (100 - drift, 200 + drift)
    clock.above(150, second)
    clock.above(-10**6, second)        # looser than the aged bound: kept out
    assert clock.bounds(second) == (150, 200 + drift)
    clock.below(170, second)
    assert clock.offset(second) == 160
    clock.above(50_000, 2 * second)    # past the upper bound: both move to it
    assert clock.bounds(2 * second) == (50_000, 50_000)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(_trace, "_clocks", {0: _trace.Clock(1000, 3000, 0)})
    _trace.bound(card, (500, -1500), (7000, 9000))   # launched at 500 -> stamp -1500; stamp 7000 -> read at 9000
    assert _trace._clocks[0].bounds(9000) == (2000, 2000) and _trace.offset(card, 9000) == 2000
    _trace.bound(torch.device("cpu"), (0, 0), (0, 0))
    assert _trace.offset(torch.device("cpu"), 0) == 0 and _trace.offset(torch.device("cuda", 1), 0) == 0
    # a profiler session begun since the calibration: calibrated anew, once
    calibrated = []
    monkeypatch.setattr(_trace, "calibrate", lambda d: calibrated.append(d) or _trace._clocks.setdefault(
        d.index, _trace.Clock(0, 0, 0, profiled=True)))
    assert not _trace.follow(card, False) and _trace.follow(card, True) and not _trace.follow(card, True)
    assert calibrated == [card] and not _trace.follow(torch.device("cpu"), True)
