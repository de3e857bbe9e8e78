"""The check decides ``correct``: a run of the sound program passes, and a
run with the timed path broken underneath fails, for each fault a cell of
this benchmark can have (``faults.py``). The runs skip the look for a card
and drive the rest of a run on the CPU at a tiny size, where the program's
plain route and the reference are the same arithmetic. (The exchange
between chips has no counterpart: every cell runs on one card.)"""

from __future__ import annotations

import json

import pytest
import torch
from conftest import REPO, run_tiny

from ptzbench import check, faults

CELLS = ["tiny_redetect.steady", "tiny_klt.steady", "tiny_redetect.live"]


def _limit(cell, name):
    """The committed limit of the cell that the tiny ``cell`` stands for."""
    committed = {"tiny_redetect": "redetect720", "tiny_klt": "klt720"}
    frontend, mix = cell.split(".")
    return json.loads((REPO / f"ptzbench/limits/{committed[frontend]}.{mix}.json").read_text())[name]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny_root, cell):
    res, lines = run_tiny(tiny_root, cell)
    assert res["correct"], lines
    assert all(v["value"] == 0 for v in res["checks"].values())    # the same arithmetic on the CPU
    assert res["look"]["_stores_compared"] == 1                    # a segment without a loss: its stores compared


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "insert"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(tiny_root, cell, fault):
    by = {"altered": 3 * _limit(cell, "step_gap_rad"), "insert": 3 * _limit(cell, "kf_gap_rad")}.get(fault, 0.0)
    res, lines = run_tiny(tiny_root, cell, program_cls=faults.make(fault, by))
    assert not res["correct"], lines


def test_verdict_needs_every_number_under_its_limit():
    nums = dict.fromkeys(check.NUMBERS, 0.0)
    limits = dict.fromkeys(check.NUMBERS, 1.0)
    assert check.verdict(nums, limits)[0]
    assert not check.verdict({**nums, "step_gap_rad": 1.5}, limits)[0]
    assert not check.verdict({**nums, "pose_gap_p50_rad": float("nan")}, limits)[0]
    # a number the cell does not compare does not count, and is not shown
    ok, shown = check.verdict({**nums, "kf_gap_rad": 9.0}, {"step_gap_rad": 1.0})
    assert ok and list(shown) == ["step_gap_rad"]
    with pytest.raises(ValueError):
        check.verdict(nums, {})
    with pytest.raises(ValueError):
        check.verdict(nums, {"focal_gap_p50_rel": 1.0})


def _infos(pan, lost, event=None):
    from ptzbench.reference.slam import FrameInfo

    n = len(pan)
    pose = torch.tensor([[p, -0.05, 2000.0] for p in pan], dtype=torch.float32)
    z = torch.zeros(n)
    ev = torch.tensor(event if event is not None else [0] * n)
    return FrameInfo(pose, z, z, z, torch.tensor(lost), z, z, ev, z, z)


def _end():
    from ptzbench.reference.config import SLAMConfig
    from ptzbench.reference.mapstore import init_keyframe_store, init_ray_store
    from ptzbench.reference.slam import SlamState

    cfg = SLAMConfig(max_keyframes=2, max_keypoints=4, max_map_rays=4, kf_desc_dim=2)
    return SlamState(None, None, init_keyframe_store(cfg), init_ray_store(cfg), None, None)


def test_medians_run_over_the_calm_prefix():
    end = _end()
    a = _infos([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], [False] * 6)
    # the reference loses frame 4 and relocalizes at frame 5 to another pose
    b = _infos([0.1, 0.2 + 1e-6, 0.3, 0.4, 0.5, 0.7], [False, False, False, False, True, False], [0, 0, 0, 0, 0, 1])
    got = check.compare(a, b, end, end)
    assert got["_calm_frames"] == 4 and got["_lost_mismatch"] == 1
    # the prefix's gaps (0, 1e-6, 0, 0): upper median 0; the 0.1 after it is a look only
    assert got["pose_gap_p50_rad"] == 0.0 and got["_max_gap_rad"] == pytest.approx(0.1, rel=1e-5)
    assert got["step_gap_rad"] == pytest.approx(1e-6, rel=0.2)
    # one frame of six lost on one side only; the stores are not compared after a loss
    assert got["bad_frame_pct"] == pytest.approx(100 / 6) and got["_stores_compared"] == 0
    # a frame of the first STEP_FRAMES lost on one side only: an infinite step
    c = _infos([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], [False, True, False, False, False, False])
    assert check.compare(a, c, end, end)["step_gap_rad"] == float("inf")
    shifted = _infos([p + 1e-3 for p in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)], [False] * 6)
    assert check.compare(a, shifted, end, end)["pose_gap_p50_rad"] == pytest.approx(1e-3, rel=1e-3)
    assert all(v == 0 for k, v in check.compare(a, a, end, end).items() if k in check.NUMBERS)


def test_bad_frames_count_the_calm_prefix_gaps_and_every_lost_flag():
    end = _end()
    a = _infos([0.1] * 8, [False] * 8)
    # frames 5 and 6 off by more than BAD_RAD, 7 lost by the reference
    off = 2 * check.BAD_RAD
    b = _infos([0.1] * 5 + [0.1 + off, 0.1 + off, 0.1], [False] * 7 + [True])
    assert check.compare(a, b, end, end)["bad_frame_pct"] == pytest.approx(100 * 3 / 8)
    # after a loss on both sides the gaps part sound runs: only lost flags count there
    a2 = _infos([0.1] * 8, [False, True] + [False] * 6)
    b2 = _infos([0.1, 0.1] + [0.1 + off] * 5 + [0.1], [False, True] + [False] * 5 + [True])
    assert check.compare(a2, b2, end, end)["bad_frame_pct"] == pytest.approx(100 / 8)


def _kf_store(poses, valid, frame_idx):
    from ptzbench.reference.mapstore import KeyframeStore

    k = len(poses)
    z = torch.zeros(k, 2, 2)
    return KeyframeStore(
        torch.tensor(poses, dtype=torch.float32), torch.tensor(frame_idx, dtype=torch.int32), torch.tensor(valid),
        z, torch.zeros(k, 2, 2), torch.zeros(k, 2, dtype=torch.int32), torch.zeros(k, 2, dtype=torch.bool),
        torch.tensor(sum(valid)),
    )


def test_kf_gap_compares_the_rows_the_segment_wrote():
    start = _kf_store([[0.1, 0.0, 2000.0], [0.0, 0.0, 0.0]], [True, False], [0, 0])
    prog = _kf_store([[0.1, 0.0, 2000.0], [0.2, 0.01, 2000.0]], [True, True], [0, 120])
    ref = _kf_store([[0.1, 0.0, 2000.0], [0.2, 0.01 + 3e-4, 2000.0]], [True, True], [0, 120])
    assert check.kf_gap(prog, ref, start) == (pytest.approx(3e-4, rel=1e-3), 0)
    # a row the reference did not write: infinite
    none = _kf_store([[0.1, 0.0, 2000.0], [0.0, 0.0, 0.0]], [True, False], [0, 0])
    assert check.kf_gap(prog, none, start) == (float("inf"), 1)
    # nothing written: nothing compared
    assert check.kf_gap(start, start, start) == (0.0, 0)


def test_map_unmatched_counts_both_sides():
    from ptzbench.reference.mapstore import RayStore

    def store(rays, valid):
        rays = torch.tensor(rays, dtype=torch.float32)
        z = torch.zeros(len(rays))
        return RayStore(rays, z[:, None], torch.tensor(valid), z.int(), z.int().sum(), z.int())

    a = store([[0.0, 0.0], [0.1, 0.1], [0.5, 0.5]], [True, True, False])
    b = store([[0.0, 0.0005], [0.3, 0.3], [0.1, 0.1]], [True, True, True])
    # a's two valid rays have partners; b's (0.3, 0.3) has none: 1 of 5
    assert check.map_unmatched_pct(a, b) == pytest.approx(20.0)
