"""The per-layer metrics that read the program's own stamps and spans
(``ptzbench/stamps.py``, ``ptzjax_torch._trace``), on planted call records:
each reads what its definition says, and none reads anything where the
program has no stamps (a checkout from before them) or the window no call.
The stamps themselves are tested with the program (``tests/test_torch_trace.py``,
``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import sys
import time

import pytest

from ptzbench import run, stamps
from ptzbench.registry import Registry

NEW = (
    "frontend_ms_per_frame", "association_ms_per_frame", "filter_ms_per_frame", "map_ms_per_frame", "insert_ms",
    "frame_gap_ms", "call_lead_ms", "call_tail_ms",
)


def _call(entry, rows, ret, counts, sums):
    """A complete record: entry and return on the host, the frames' (first,
    last) stamps, the branch counts and the stage sums by stamp name."""
    from ptzjax_torch import _trace

    rec = _trace.Call()
    rec.host = [entry, entry + 1, entry + 2, 0, 0, 0, ret]
    rec.frames = rec.launched = len(rows) // 2
    rec.rows = list(rows)
    rec.counts = counts
    rec.sums = [0] * len(_trace.STAMPS)
    for name, ns in sums.items():
        rec.sums[_trace.INDEX[name]] = ns
    return rec


MS = 1_000_000


@pytest.fixture
def planted(monkeypatch):
    """Two calls as the window: three tracked frames (one with an insert
    and the windowed BA) and two, one of them lost."""
    from ptzjax_torch import _trace

    records = [
        _call(100 * MS, [101 * MS, 103 * MS, 103 * MS + 400_000, 105 * MS + 400_000, 106 * MS, 114 * MS], 115 * MS,
              [0, 3, 1, 0], {"track.frontend": 600_000, "track.predict": 30_000, "track.association": 900_000,
                             "track.update": 1_500_000, "track.map": 1_200_000, "insert+ba.keyframe": 1_000_000,
                             "insert+ba.merge": 2_000_000, "insert+ba.ba": 3_000_000, "insert+ba.tail": 100_000}),
        _call(200 * MS, [200 * MS + 500_000, 202 * MS + 500_000, 203 * MS + 100_000, 208 * MS], 209 * MS + 500_000,
              [1, 1, 0, 0], {"track.frontend": 200_000, "track.predict": 10_000, "track.association": 300_000,
                             "track.update": 500_000, "track.map": 400_000}),
    ]
    monkeypatch.setattr(_trace, "window", lambda ring=None: records)
    return records


WANT = {
    "frontend_ms_per_frame": 0.8 / 4,
    "association_ms_per_frame": 1.2 / 4,
    "filter_ms_per_frame": 2.04 / 4,
    "map_ms_per_frame": 1.6 / 4,
    "insert_ms": 6.1,
    "frame_gap_ms": (0.4 + 0.6 + 0.6) / 3,
    "call_lead_ms": (1.0 + 0.5) / 2,
    "call_tail_ms": (1.0 + 1.5) / 2,
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_its_definition_on_planted_records(planted, metric):
    reg = Registry(run.ROOT)
    assert reg.reader(metric)(None) == pytest.approx(WANT[metric], rel=1e-12)


@pytest.mark.parametrize("metric", NEW)
def test_reader_finds_nothing_without_the_programs_stamps(monkeypatch, metric):
    """An empty window, and a program without ``_trace``: no value."""
    import ptzjax_torch
    from ptzjax_torch import _trace

    reader = Registry(run.ROOT).reader(metric)
    monkeypatch.setattr(_trace, "window", lambda ring=None: [])
    assert reader(None) is None
    monkeypatch.delattr(ptzjax_torch, "_trace")
    monkeypatch.setitem(sys.modules, "ptzjax_torch._trace", None)   # the import then raises
    assert stamps.window() == [] and reader(None) is None


def test_new_metrics_are_entries_of_their_cells():
    reg = Registry(run.ROOT)
    steady = {m["name"] for m in reg.cell("redetect720.steady").per_layer}
    live = {m["name"] for m in reg.cell("redetect720.live").per_layer}
    assert set(NEW[:6]) <= steady and set(NEW[6:]) <= live and not set(NEW) & steady & live
    for m in reg.bench["per_layer"]:
        if m["name"] in NEW:
            assert m["source"] == "program_counter" and m["unit"] == "ms" and m["better"] == "lower"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_redetect.steady", "tiny_redetect.live"])
def test_a_traced_run_on_the_card_reports_the_stamped_metrics(tiny_root, cuda_device, cell):
    """A short traced run of a tiny cell on the card reports every new
    metric of its cell, from the window's calls alone."""
    reg = Registry(tiny_root)
    c = reg.cell(cell)
    res, lines = run.run_cell(reg, c, 2**31 + 11, 2.0, True, cuda_device, t_import=time.perf_counter())
    assert res["correct"], lines
    want = {m["name"] for m in c.per_layer} & set(NEW)
    assert want and want <= set(res["metrics"]), res["metrics"]
    assert all(res["metrics"][m]["value"] > 0 for m in want)
