"""The reading of a device trace: kernel names, busy time, idle gaps."""

from __future__ import annotations

import pytest

from ptzbench import trace
from ptzbench.trace import Op, Trace


def test_kernel_names():
    assert trace.short("void (anonymous namespace)::detect_kernel(float const*, int)") == "{anonymous}::detect_kernel"
    assert trace.base("void (anonymous namespace)::detect_kernel(float const*, int)") == "detect_kernel"
    assert trace.base("void ns::pyramid_kernel<3, float>(PyrParams)") == "pyramid_kernel"
    assert trace.short("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
    assert not trace.is_kernel(Op("Memset (Device)", 0, 1)) and trace.is_kernel(Op("k", 0, 1))
    ops = [Op("void a::k(int)", 0, 5), Op("void (anonymous namespace)::k(float)", 9, 5), Op("j", 20, 1)]
    assert len(trace.named(ops, "k")) == 2


def test_busy_is_the_union_of_intervals():
    ops = [Op("a", 0, 10), Op("b", 5, 10), Op("c", 30, 5), Op("d", 31, 1)]
    assert trace.busy_intervals(ops) == [(0, 15), (30, 35)]
    assert trace.busy_s(ops) == pytest.approx(20e-9)


def test_idle_gaps_are_named_by_the_innermost_host_record():
    dev = [Op("a", 0, 10), Op("b", 20, 10), Op("c", 100, 5)]
    host = [Op("call", 0, 200), Op("launch", 15, 10), Op("read", 40, 80)]
    gaps = trace.idle_gaps(Trace(dev, host, 1.0))
    assert gaps == [["read", pytest.approx(70e-9)], ["launch", pytest.approx(10e-9)]]


def test_top_ops_sum_by_name():
    ops = [Op("void k(int)", 0, 3), Op("void k(int)", 5, 4), Op("void j(int)", 10, 2)]
    assert trace.top_ops(ops) == [["k", pytest.approx(7e-9)], ["j", pytest.approx(2e-9)]]


def _match_view(branches, launches, fields):
    from types import SimpleNamespace

    ops = [Op("void (anonymous namespace)::match_kernel(float const*)", 10 * i, 1000) for i in range(launches)]
    return SimpleNamespace(
        trace=Trace(ops, [], 1.0), branches=branches, kernels={"match": "match_kernel"}, fields=fields,
    )


def test_match_reader_counts_two_launches_an_insert_frame():
    from conftest import REPO

    from ptzbench import roofline
    from ptzbench.registry import Registry

    read = Registry(REPO).reader("match_roofline")
    f = dict(reloc_mode="map", max_keypoints=8, kf_desc_dim=4, max_rays=6, max_map_rays=16)
    gated = roofline.match_work(8, 6, 4, gated=True, mutual=True)
    ungated = roofline.match_work(8, 16, 4, gated=False, mutual=True)
    # 4 frames that tracked, one of them an insert (counted under "track" and
    # "insert+ba", as the frame graph's counts hold it), and 1 lost frame:
    # 4 + 1 gated launches and 1 over the map (as a traced stretch on the
    # card reads: 359 frames, "track" 359, "insert+ba" 2, 361 launches)
    b = {"track": 4, "insert+ba": 1, "insert": 0, "lost": 1}
    got = read(_match_view(b, 6, f))
    assert got == pytest.approx(roofline.share_pct([gated] * 5 + [ungated], 6e-6))
    # launches that do not number what the branches launch: nothing is read
    assert read(_match_view(b, 5, f)) is None and read(_match_view(b, 7, f)) is None
