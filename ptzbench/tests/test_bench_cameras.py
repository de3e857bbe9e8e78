"""The harness at several genlocked cameras on one card (a configuration's
``cameras``), on the CPU at the tiny size of the other harness tests:
camera 0 is the one-camera stream bit for bit, the other cameras have
their own phase and panorama, every camera's frames fall due together in
an open loop, ``attempted`` and ``failed`` are summed, a fault planted in
one camera alone fails the check, and a configuration without ``cameras``
runs today's one-camera path to today's result."""

from __future__ import annotations

import json
import shutil
import threading

import numpy as np
import pytest
import torch
from conftest import REPO, make_tiny_root, run_tiny

from ptzbench import faults, program, run
from ptzbench.generator import Traffic, camera_scene, genlocked

SEED = 2**31 + 7
TWO = "tiny_redetect_x2"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark root with a copy of the tiny re-detect
    configuration at two cameras, under the committed live and steady
    mixes and limits."""
    root = make_tiny_root(tmp_path_factory.mktemp("cameras"))
    cfg = json.loads((root / "ptzbench/configs/tiny_redetect.json").read_text())
    cfg["cameras"] = 2
    (root / f"ptzbench/configs/{TWO}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": TWO, "source": "x", "file": f"ptzbench/configs/{TWO}.json", "reduced": [], "why": "x"})
    for mix in ("live", "steady"):
        cell = f"{TWO}.{mix}"
        bench["workloads"].append({"name": cell, "config": TWO, "traffic": mix, "chips": 1, "why": "x"})
        shutil.copy(REPO / f"ptzbench/limits/redetect720.{mix}.json", root / f"ptzbench/limits/{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"redetect720.{mix}" in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root


def _mix(root, name):
    return json.loads((root / "ptzbench/traffic" / f"{name}.json").read_text())


def _take(tr, n):
    it = tr.calls()
    return [next(it) for _ in range(n)]


class Recorder(program.Program):
    """The sound program, keeping each window call's frames and answers
    (not the warm-up's) in ``calls``."""

    made: list = []

    def __init__(self, *args):
        super().__init__(*args)
        self.calls, self.warming = [], False
        Recorder.made.append(self)

    def warm_up(self, state, carry, imgs):
        self.warming = True
        super().warm_up(state, carry, imgs)
        self.warming = False

    def call(self, state, carry, imgs):
        state, carry, infos = super().call(state, carry, imgs)
        if not self.warming:
            self.calls.append((imgs.clone(), infos))
        return state, carry, infos


class LosesEveryThird(Recorder):
    """Reports every third frame lost (the state goes on as it was)."""

    def call(self, state, carry, imgs):
        state, carry, infos = super().call(state, carry, imgs)
        if not self.warming and len(self.calls) % 3 == 0:
            infos = infos._replace(lost=torch.ones_like(infos.lost))
            self.calls[-1] = (self.calls[-1][0], infos)
        return state, carry, infos


@pytest.fixture
def recorder():
    Recorder.made = []
    yield Recorder
    Recorder.made = []


def test_camera0_is_the_one_camera_stream(root):
    mix = _mix(root, "live")
    today, cam0 = Traffic(mix, SEED), Traffic(mix, SEED, camera=0)
    assert cam0.phase == today.phase and cam0.scene == today.scene == {"main": 0}
    assert _take(cam0, 40) == _take(today, 40)
    a = run.make_stream(today, 320, 180, torch.device("cpu"))
    b = run.make_stream(cam0, 320, 180, torch.device("cpu"))
    assert torch.equal(a.stacks["main"], b.stacks["main"])
    np.testing.assert_array_equal(a.poses["main"], b.poses["main"])


def test_camera0_calls_are_the_one_camera_runs(root, recorder):
    """In the open loop (a fixed set of calls) camera 0 of two gets the
    one-camera run's frames and gives its answers, bit for bit."""
    run_tiny(root, "tiny_redetect.live", seconds=1.0, seed=SEED, program_cls=recorder)
    (alone,) = recorder.made
    recorder.made = []
    run_tiny(root, f"{TWO}.live", seconds=1.0, seed=SEED, program_cls=recorder)
    cam0, cam1 = recorder.made
    assert len(alone.calls) == len(cam0.calls) == len(cam1.calls) == 30
    for (img_a, info_a), (img_b, info_b) in zip(alone.calls, cam0.calls):
        assert torch.equal(img_a, img_b)
        for x, y in zip(info_a, info_b):
            assert torch.equal(x, y)
    assert not torch.equal(cam1.calls[0][0], cam0.calls[0][0])


def test_other_cameras_get_their_own_phase_and_panorama(root):
    mix = _mix(root, "cuts")
    seeds = (SEED, 5, 2**31 + 901)
    for seed in seeds:
        cam0, cam1, again = Traffic(mix, seed), Traffic(mix, seed, camera=1), Traffic(mix, seed, camera=1)
        assert (cam1.phase, cam1.scene) == (again.phase, again.scene)
        assert _take(cam1, 60) == _take(again, 60)
        np.testing.assert_array_equal(cam1.away_poses(), again.away_poses())
        # the panoramas are the scene's for camera k alone: the same work for every seed
        assert cam1.scene == {k: camera_scene(v, 1) for k, v in mix["scene"].items()}
        assert set(cam1.scene.values()).isdisjoint(cam0.scene.values())
    phases = [(Traffic(mix, s).phase, Traffic(mix, s, camera=1).phase) for s in seeds]
    assert any(p0 != p1 for p0, p1 in phases)
    live = _mix(root, "live")
    one = Traffic(live, SEED, camera=1)
    a = run.make_stream(one, 160, 96, torch.device("cpu"))
    b = run.make_stream(Traffic(live, SEED, camera=1), 160, 96, torch.device("cpu"))
    c = run.make_stream(Traffic(live, SEED), 160, 96, torch.device("cpu"))
    assert torch.equal(a.stacks["main"], b.stacks["main"])
    assert not torch.equal(a.stacks["main"], c.stacks["main"])


def test_open_loop_cameras_fall_due_together(root):
    mix = _mix(root, "live")
    cams = [Traffic(mix, SEED, camera=k) for k in range(3)]
    got = list(genlocked(cams, 1.0))
    assert len(got) == 3 * 30
    for t in range(30):
        tick = got[3 * t:3 * t + 3]
        assert [k for k, _ in tick] == [0, 1, 2]
        assert {c.due_s for _, c in tick} == {t / mix["rate_fps"]}
        assert {c.first for _, c in tick} == {t + 1}
    mine = [c for k, c in got if k == 1]
    assert mine == _take(Traffic(mix, SEED, camera=1), 30)


def test_attempted_and_failed_are_summed(root, recorder):
    res, lines = run_tiny(root, f"{TWO}.live", seconds=1.0, seed=SEED, program_cls=[Recorder, LosesEveryThird])
    cam0, cam1 = recorder.made
    frames = [sum(img.shape[0] for img, _ in p.calls) for p in (cam0, cam1)]
    lost = [sum(int(i.lost.sum()) for _, i in p.calls) for p in (cam0, cam1)]
    assert frames == [30, 30] and lost == [0, 10]
    assert res["attempted"] == 60 and res["failed"] == 10
    assert not res["correct"], lines    # camera 1's answers are not the reference's


@pytest.mark.parametrize("mix", ["live", "steady"])
def test_sound_cameras_are_correct(root, mix):
    res, lines = run_tiny(root, f"{TWO}.{mix}")
    assert res["correct"], lines
    assert all(v["value"] == 0 for v in res["checks"].values())    # the same arithmetic on the CPU


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "insert"])
@pytest.mark.parametrize("mix", ["live", "steady"])
def test_fault_in_one_camera_fails_the_check(root, mix, fault):
    limits = json.loads((REPO / f"ptzbench/limits/redetect720.{mix}.json").read_text())
    by = {"altered": 3 * limits["step_gap_rad"], "insert": 3 * limits["kf_gap_rad"]}.get(fault, 0.0)
    res, lines = run_tiny(root, f"{TWO}.{mix}", program_cls=[program.Program, faults.make(fault, by)])
    assert not res["correct"], lines


def test_one_camera_takes_todays_path_to_todays_result(root, monkeypatch):
    """Without ``cameras`` the run starts no thread and gives the result of
    the harness before cameras on this seed: every number but the clock's
    (the look adds the locked prefix's length, ``_locked_frames``)."""

    def no_thread(*args, **kwargs):
        raise AssertionError("a thread at one camera")

    monkeypatch.setattr(threading.Thread, "start", no_thread)
    res, _ = run_tiny(root, "tiny_redetect.live", seconds=1.0, seed=SEED)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "look", "checks"]
    assert list(res["metrics"]) == ["latency_p95_ms", "setup_s"]
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert (res["correct"], res["attempted"], res["failed"]) == (True, 30, 0)
    assert res["look"] == {
        "step_gap_rad": 0.0, "pose_gap_p50_rad": 0.0, "bad_frame_pct": 0.0, "kf_gap_rad": 0.0, "_calm_frames": 24,
        "_locked_frames": 24, "_stores_compared": 1, "_pose_gap_max_rad": 0.0, "_focal_gap_p50_rel": 0.0,
        "_map_unmatched_pct": 0.0, "_max_gap_rad": 0.0, "_max_focal_rel": 0.0, "_lost_mismatch": 0, "_kf_valid_mismatch": 0,
    }
    assert res["checks"] == {
        "step_gap_rad": {"value": 0.0, "limit": 1e-06}, "pose_gap_p50_rad": {"value": 0.0, "limit": 1.5e-06},
        "kf_gap_rad": {"value": 0.0, "limit": 5e-05},
    }
    steady, _ = run_tiny(root, "tiny_redetect.steady", seconds=1.0, seed=SEED)
    assert list(steady["metrics"]) == ["fps", "setup_s"] and steady["correct"]


@pytest.mark.parametrize("cell, cameras", [("tiny_redetect.live", 1), (f"{TWO}.live", 2)])
def test_view_covers_every_camera(root, monkeypatch, cell, cameras):
    views, view_cls = [], run.View

    def keep(**kw):
        views.append(view_cls(**kw))
        return views[-1]

    monkeypatch.setattr(run, "View", keep)
    run_tiny(root, cell, seconds=1.0, traced=True, seed=SEED)
    (view,) = views
    frames = _mix(root, "live")["trace"]["frames"]
    assert view.cameras == cameras and view.frames == cameras * frames and len(view.walls_s) == cameras * frames
    assert view.window_frames == cameras * 30
    assert len(view.sample(4)) == 4
