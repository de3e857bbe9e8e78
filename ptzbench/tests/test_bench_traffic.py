"""The traffic generator and the end-to-end arithmetic."""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest
from conftest import REPO, run_tiny

from ptzbench import frames, run
from ptzbench.generator import Traffic


def _mix(name):
    return json.loads((REPO / "ptzbench/traffic" / f"{name}.json").read_text())


def _take(tr, n):
    it = tr.calls()
    return [next(it) for _ in range(n)]


def test_steady_calls_are_chunks_of_the_periodic_stack():
    tr = Traffic(_mix("steady"), 2**31 + 99)
    calls = _take(tr, 20)
    assert calls[0].first == 1 and calls[0].count == 119            # frame 0 is the init frame
    assert all(c.count == 120 and c.first % 120 == 0 for c in calls[1:])
    assert all(c.row == c.first % 720 and c.source == "main" and c.due_s is None for c in calls)
    assert all(a.first + a.count == b.first for a, b in zip(calls, calls[1:]))
    assert tr.warmup() == calls[0]


def test_path_is_the_soaks_and_periodic():
    mix = _mix("steady")
    tr = Traffic(mix, 5)
    poses = tr.main_poses()
    t = np.arange(tr.phase, tr.phase + 720, dtype=np.float64)
    want_pan = 0.12 * np.sin(2 * np.pi * t / 720) + 0.05 * np.sin(2 * np.pi * t / 240)
    np.testing.assert_allclose(poses[:, 0], want_pan.astype(np.float32), rtol=0, atol=1e-7)
    again = frames.trajectory(mix["path"], 720, tr.phase + 720)
    np.testing.assert_allclose(poses, again, rtol=1e-6, atol=1e-6)


def test_live_is_one_frame_a_call_at_its_rate():
    mix = _mix("live")
    calls = _take(Traffic(mix, 3), 50)
    assert all(c.count == 1 for c in calls)
    np.testing.assert_allclose([c.due_s for c in calls], np.arange(50) / mix["rate_fps"])


def test_cuts_every_seed_does_the_same_shots_in_another_order():
    mix = _mix("cuts")
    cycle = sum(mix["cuts"]["main"]) + sum(mix["cuts"]["away"])
    orders = []
    for seed in (1, 2**31 + 3, 77):
        calls = _take(Traffic(mix, seed), 400)
        shots, cur = [], None
        for c in calls:
            if c.first > 3 * cycle:
                break
            if cur and cur[0] == c.source:
                cur[1] += c.count
            else:
                cur = [c.source, c.count]
                shots.append(cur)
        main = [n for s, n in shots if s == "main"][:3]
        away = [n for s, n in shots if s == "away"][:3]
        assert Counter(main) == Counter(mix["cuts"]["main"]) and Counter(away) == Counter(mix["cuts"]["away"])
        orders.append((tuple(main), tuple(away)))
        for a, b in zip(calls, calls[1:]):
            if b.source == "main" and a.source == "away":
                assert "return" in b.tags
            assert ("away" in b.tags) == (b.source == "away")
            assert b.first == a.first + a.count and b.count <= mix["chunk"]
    assert len(set(orders)) > 1


def test_same_seed_same_calls_and_frames():
    mix = _mix("cuts")
    a, b = Traffic(mix, 2**31 + 11), Traffic(mix, 2**31 + 11)
    assert _take(a, 60) == _take(b, 60)
    np.testing.assert_array_equal(a.main_poses(), b.main_poses())
    np.testing.assert_array_equal(a.away_poses(), b.away_poses())


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.random(n).tolist()
        for q in (50, 95, 99):
            assert run.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_render_is_synth_render_image():
    import torch

    from ptzjax_torch import synth
    from ptzjax_torch.geometry import Intrinsics

    pano = frames.make_panorama(3, "cpu", texels_per_rad=400.0)
    cams = np.array([[0.05, -0.05, 500.0], [-0.1, 0.02, 420.0]], np.float32)
    got = frames.host_stack(pano, cams, 160, 96, pin=False)
    ref_pano = synth.Panorama(pano.tex.numpy(), pano.theta0, pano.phi0, pano.dtheta, pano.dphi)
    want = np.stack([synth.render_image(ref_pano, c, Intrinsics.create(80, 48), 160, 96) for c in cams])
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(pano.tex.mean()) == pytest.approx(0.0, abs=1e-5) and float(pano.tex.std()) == pytest.approx(1.0, rel=1e-4)
    assert torch.equal(frames.make_panorama(3, "cpu", texels_per_rad=400.0).tex, pano.tex)


def test_fps_is_frames_over_the_windows_wall(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny_redetect.steady", seconds=1.0)
    fps = res["metrics"]["fps"]["value"]
    assert res["attempted"] > 0 and 0 < fps < 1e4


def test_open_loop_reports_p95_latency(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny_redetect.live", seconds=1.0)
    lat = res["metrics"]["latency_p95_ms"]
    assert lat["unit"] == "ms" and lat["value"] > 0
    assert "fps" not in res["metrics"]
