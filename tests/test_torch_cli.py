"""The port's CLI (``ptzjax_torch.run``) against the reference's
(``ptzjax.run``) on the CPU: the same arguments through both, in process,
and the per-frame logs and summaries compared. Flags and keyframes must be
equal, poses within 5e-4 rad (pan, tilt) and 2 px (focal), and the summaries
must have the same keys, lost frames and keyframes.

Sizes follow tests/test_run_cli.py (480x270 or 640x360, 12-30 frames)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from jax._src import config as jcfg

from ptzjax import run as jrun
from ptzjax_torch import run as trun
from ptzjax_torch import synth as tsynth
from ptzjax_torch.geometry import Intrinsics
from tests._torch_port import port_cfg, port_intr, reference_forest_module, render, small_cfg

torch.set_num_threads(2)

IMG = ("--width", "480", "--height", "270")


def _read(out):
    with open(os.path.join(out, "frames.jsonl")) as f:
        records = [json.loads(line) for line in f]
    with open(os.path.join(out, "summary.json")) as f:
        return records, json.load(f)


def ref(out, *argv):
    """``python -m ptzjax.run <argv> --platform cpu``, in this process. Its
    persistent compilation cache stays off and the process's cache settings
    are restored after it, so no later test of this worker reads it."""
    saved = sys.argv, jcfg.compilation_cache_dir.value, jcfg.enable_compilation_cache.value
    sys.argv = ["ptzjax.run", *argv, "--out", str(out), "--platform", "cpu"]
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        jrun.main()
    finally:
        sys.argv = saved[0]
        jax.config.update("jax_compilation_cache_dir", saved[1])
        jax.config.update("jax_enable_compilation_cache", saved[2])
        compilation_cache.reset_cache()
    return _read(out)


def port(out, *argv):
    """``python -m ptzjax_torch.run <argv> --device cpu``, in this process."""
    trun.main([*argv, "--out", str(out), "--device", "cpu"])
    return _read(out)


def assert_parity(got, want, frames=None):
    """The port's (records, summary) against the reference's; ``frames``
    limits the comparison to those frame numbers."""
    (rec_t, sum_t), (rec_j, sum_j) = got, want
    if frames is not None:
        rec_t = [r for r in rec_t if r["frame"] in frames]
        rec_j = [r for r in rec_j if r["frame"] in frames]
    else:
        assert sorted(sum_t) == sorted(sum_j)
        for key in ("frames_lost", "keyframes", "frontend", "mode", "frontend_focals", "ba_robust", "tracker"):
            assert sum_t.get(key) == sum_j.get(key), key
    assert [r["frame"] for r in rec_t] == [r["frame"] for r in rec_j] and rec_t
    assert [sorted(r) for r in rec_t] == [sorted(r) for r in rec_j]
    for key in ("lost", "keyframe", "event"):
        assert [r[key] for r in rec_t] == [r[key] for r in rec_j], key
    d = np.abs(np.array([r["pose"] for r in rec_t]) - np.array([r["pose"] for r in rec_j]))
    assert d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, d.max(0)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The reference's --synthetic run of 30 frames with checkpoints every
    10 frames."""
    out = tmp_path_factory.mktemp("ref_synthetic")
    return out, ref(out, "--synthetic", "--frames", "30", "--checkpoint-every", "10")


def test_synthetic_with_checkpoints(synthetic, tmp_path):
    ref_out, want = synthetic
    got = port(tmp_path, "--synthetic", "--frames", "30", "--checkpoint-every", "10")
    assert_parity(got, want)
    assert len(got[0]) == 29 and got[1]["frames_lost"] == 0 and got[1]["pan_mae_deg"] < 0.1
    for name in ("state_000010.npz", "state_000020.npz", "trajectory.npz"):
        assert os.path.exists(tmp_path / name) and os.path.exists(ref_out / name)
    np.testing.assert_allclose(np.load(tmp_path / "trajectory.npz")["gt"], np.load(ref_out / "trajectory.npz")["gt"])


def test_resume_a_reference_checkpoint(synthetic, tmp_path):
    """A checkpoint written by ``ptzjax.run`` resumes in ``ptzjax_torch.run``
    at the frame after it and continues like the uninterrupted reference."""
    ref_out, want = synthetic
    got = port(tmp_path, "--synthetic", "--frames", "30", "--resume", str(ref_out / "state_000020.npz"))
    assert [r["frame"] for r in got[0]] == list(range(21, 30))
    assert got[1]["frames_lost"] == 0
    assert_parity(got, want, frames=range(21, 30))


def test_plot(synthetic, tmp_path):
    """--plot writes the trajectory/error figure; the 20-frame run's frames
    are the 30-frame reference run's first 19."""
    pytest.importorskip("matplotlib")
    got = port(tmp_path, "--synthetic", "--frames", "20", "--plot")
    png = tmp_path / "trajectory.png"
    assert png.exists() and os.path.getsize(png) > 10_000
    assert_parity(got, synthetic[1], frames=range(1, 20))


def _config(tmp_path, cfg) -> str:
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def test_synthetic_court(tmp_path):
    """--synthetic-court at tests/test_court.py's caps (128 slots), where
    the reference tracks every frame. (At the default 256 slots the
    reference's factor-and-invert recursion loses frame 1 of this sequence,
    2.6e-2 rad off in pan, where the port's direct solve is 5.9e-5 rad
    off: ROADMAP queue 3.)"""
    from ptzjax.config import SLAMConfig

    cfg = SLAMConfig(max_rays=128, max_keypoints=256, max_map_rays=2048, max_keyframes=16, sigma_obs=0.7)
    argv = ("--synthetic-court", "--frames", "60", "--config", _config(tmp_path, cfg))
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert got[1]["frames_lost"] == 0 and got[1]["pan_mae_deg"] < 0.1


@pytest.mark.parametrize("mode", ["keyframe", "forest"])
def test_reloc_backends(tmp_path, mode):
    """--reloc keyframe / forest drive the loop (the forest also trains
    online from the keyframes)."""
    if mode == "forest":
        reference_forest_module()
    argv = ("--synthetic", "--frames", "20", "--reloc", mode)
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert got[1]["frames_lost"] == 0 and got[1]["pan_mae_deg"] < 0.1


@pytest.mark.parametrize("mode", ["re-detect", "klt"])
def test_synthetic_images(tmp_path, mode):
    """The from-pixels path at 480x270; KLT mode with a checkpoint at frame
    6, whose resume rebuilds the KLT carry (below)."""
    argv = ("--synthetic-images", "--frames", "12", *IMG, "--chunk", "8")
    if mode == "klt":
        argv += ("--klt", "--checkpoint-every", "6")
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert got[1]["frontend"] == "fused" and got[1]["frames_lost"] == 0 and len(got[0]) == 11
    if mode == "klt":
        # resume the reference's frame-6 checkpoint in both packages: the
        # carry is re-detected from frame 6 at the checkpoint's focal
        ckpt = str(tmp_path / "j" / "state_000006.npz")
        got = port(tmp_path / "tr", *argv[:-2], "--resume", ckpt)
        want = ref(tmp_path / "jr", *argv[:-2], "--resume", ckpt)
        assert [r["frame"] for r in got[0]] == list(range(7, 12))
        assert_parity(got, want)


def test_movers(tmp_path):
    """--movers 4 (masked): the mover metadata and the masked detection of
    tests/test_run_cli.py's mover run."""
    cfg_path = _config(tmp_path, small_cfg())
    argv = (
        "--synthetic-images", "--movers", "4", "--frames", "14", "--width", "640", "--height", "360",
        "--f0", "1100", "--f-amp", "60", "--pan-amp", "0.12", "--config", cfg_path, "--chunk", "10",
    )
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    for key in ("movers", "movers_masked", "mover_pixel_frac_mid"):
        assert got[1][key] == want[1][key], key
    assert got[1]["movers_masked"] is True and got[1]["frames_lost"] == 0


def test_cv2_frontend(tmp_path):
    """--frontend cv2: OpenCV SIFT tables staged on the host, then the
    features path."""
    pytest.importorskip("cv2")
    argv = ("--synthetic-images", "--frontend", "cv2", "--frames", "12", *IMG)
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert got[1]["frontend"] == "cv2"


def _dataset(tmp_path, boxes: bool):
    """The --synthetic-images default sequence at 480x270 as 8-bit PNGs
    (cv2), with a .mat annotation in the reference dataset's struct layout
    (player boxes on every frame, or none) and the same ground truth as an
    .npz annotation."""
    import cv2
    import scipy.io as sio

    from ptzjax_torch import io as tio

    t, w, h = 12, 480, 270
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = tsynth.make_panorama(seed=0)
    cams = tsynth.make_trajectory(t, seed=0)
    rec = np.zeros((t,), dtype=[("ptz", object), ("image_name", object), ("bounding_box", object)])
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for k, c in enumerate(cams):
        img = tsynth.render_image(pano, c, intr, w, h)
        cv2.imwrite(str(img_dir / f"f{k:04d}.png"), np.clip(img * 40.0 + 128.0, 0, 255).astype(np.uint8))
        box = np.array([[60.0 + 5 * k, 40.0, 160.0 + 5 * k, 120.0]]) if boxes else np.zeros((0, 4))
        rec[k] = (cams[k].astype(np.float64), f"f{k:04d}.png", box)
    mat = str(tmp_path / "seq.mat")
    sio.savemat(mat, {"annotation": rec, "meta": {"cc": np.array([w / 2.0, h / 2.0])}})
    npz = str(tmp_path / "seq.npz")
    tio.save_annotations_npz(npz, cams, intr, [f"f{k:04d}.png" for k in range(t)])
    return mat, npz, str(img_dir)


@pytest.mark.parametrize("boxes", [False, True])
def test_dataset_mode(tmp_path, boxes):
    """--annotation/--images. With player boxes both packages read the .mat
    and mask detection. Without, the port reads the .npz (no boxes, no
    mask) and the reference the .mat whose frames have no boxes (an
    all-True mask): the same detections. (The reference cannot run an .npz
    annotation: it stacks the frames' ``None`` masks into an object array.)"""
    pytest.importorskip("cv2")
    mat, npz, img_dir = _dataset(tmp_path, boxes)
    common = ("--images", img_dir, "--frames", "12", *IMG)
    got = port(tmp_path / "t", "--annotation", mat if boxes else npz, *common)
    want = ref(tmp_path / "j", "--annotation", mat, *common)
    assert_parity(got, want)
    assert got[1]["frames_lost"] == 0 and got[1]["pan_mae_deg"] < 0.2


@pytest.mark.parametrize(
    "argv",
    [
        ("--synthetic", "--frames", "30"),
        ("--synthetic-images", "--frames", "12", *IMG),
        ("--synthetic-images", "--frames", "12", "--klt", *IMG),
    ],
    ids=["features", "images", "images-klt"],
)
def test_homography_baseline(tmp_path, argv):
    """--tracker homography on the oracle features and on staged image
    features (re-detect and KLT): the reference's flags, inlier counts and
    poses."""
    argv = (*argv, "--tracker", "homography")
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert [r["num_matches"] for r in got[0]] == [r["num_matches"] for r in want[0]]
    assert got[1]["tracker"] == "homography" and got[1]["frames_lost"] == 0


def _offline_config(tmp_path) -> str:
    """tests/test_dist.py's offline configuration at 640x360: keyframes
    every 4 frames, so the final map holds several."""
    return _config(tmp_path, small_cfg(keyframe_interval=4))


OFFLINE = ("--synthetic-images", "--offline", "--frames", "14", "--width", "640", "--height", "360",
           "--f0", "1100", "--f-amp", "60", "--pan-amp", "0.12", "--chunk", "8")


@pytest.mark.parametrize(
    "extra", [(), ("--oracle-focals",), ("--ba-huber", "2")], ids=["f_ref_frame0", "oracle-focals", "huber"]
)
def test_offline(tmp_path, extra):
    """--offline: the port's sharded frontend (one process) and BA against
    the reference on its 8-device CPU mesh (its results do not depend on the
    shard count): flags and poses, and the BA costs within rtol 1e-4."""
    argv = (*OFFLINE, "--config", _offline_config(tmp_path), *extra)
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    (_, s_t), (_, s_j) = got, want
    assert s_t["keyframes"] >= 2 and s_t["frames_lost"] == 0
    assert s_t["mesh_devices"] == 1 and s_j["mesh_devices"] == 8
    for key in ("ba_cost_before", "ba_cost_after"):
        np.testing.assert_allclose(s_t[key], s_j[key], rtol=1e-4)
    assert s_t["ba_cost_after"] <= s_t["ba_cost_before"]


def test_offline_on_staged_features(tmp_path):
    """--offline on the oracle features (--synthetic): the tables are
    "precomputed", tracking and BA run as above."""
    argv = ("--synthetic", "--offline", "--frames", "30", "--chunk", "16", "--ba-huber", "2")
    got, want = port(tmp_path / "t", *argv), ref(tmp_path / "j", *argv)
    assert_parity(got, want)
    assert got[1]["frontend_focals"] == "precomputed"


def test_torchrun_offline_two_processes(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m ptzjax_torch.run
    --offline``: both processes join a gloo world, each extracts its half
    of the frames and solves its half of the rays, rank 0 writes the
    artifacts; the records equal the one-process run's, the BA costs within
    rtol 1e-4."""
    argv = (*OFFLINE, "--config", _offline_config(tmp_path), "--device", "cpu")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "ptzjax_torch.run", *argv, "--out", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    two = _read(tmp_path / "two")
    one = port(tmp_path / "one", *argv[:-2])
    assert two[1]["mesh_devices"] == 2 and one[1]["mesh_devices"] == 1
    assert_parity(two, one)
    for key in ("ba_cost_before", "ba_cost_after"):
        np.testing.assert_allclose(two[1][key], one[1][key], rtol=1e-4)


def test_module_entry_point_runs_offline(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ptzjax_torch.run", "--synthetic", "--frames", "12", "--offline",
         "--mesh-devices", "1", "--out", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary["mode"] == "offline" and summary["mesh_devices"] == 1 and summary["frames_lost"] == 0


def test_runs_on_the_card_by_default(tmp_path):
    """No --device: the card, and without one the CLI raises before any
    work instead of falling back to the CPU. The frontend's default names
    the port's kernels."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    assert trun.parse_args(["--synthetic", "--out", "x"]).frontend == "kernels"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--synthetic", "--frames", "10", "--out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_forest_blackout_recovers_and_the_rewind_reruns_from_an_untouched_state(tmp_path, monkeypatch):
    """The factored loop on a 640x360 sweep with frames 14-16 zeroed and
    ``--reloc forest``: the chunk of frames 9-16 goes lost at frame 14 and
    is rerun from its start state up to there, the host loop relocalizes
    through the forest, and tracking resumes. No chunk modifies the state
    it was given (the rerun starts from exactly that state)."""
    from ptzjax_torch import reloc_forest
    from ptzjax_torch import slam as tslam

    # synchronous training: the async build's timing cannot change which
    # trees answer a query
    forest_cls = reloc_forest.RelocForest
    monkeypatch.setattr(reloc_forest, "RelocForest", lambda async_train: forest_cls())
    calls = []
    run_pixels = tslam.PTZSlam.run_segment_pixels

    def spy(self, state, imgs, masks=None, frame_ok=None):
        before = [v.clone() for v in torch.utils._pytree.tree_leaves(state)]
        out = run_pixels(self, state, imgs, masks, frame_ok)
        calls.append((int(state.frame_idx), len(imgs), before, state))
        return out

    monkeypatch.setattr(tslam.PTZSlam, "run_segment_pixels", spy)
    imgs, cams, intr = render(30, seed=3)
    dark = imgs.copy()
    dark[14:17] = 0.0
    args = trun.parse_args([
        "--synthetic-images", "--reloc", "forest", "--chunk", "8", "--width", "640", "--height", "360",
        "--out", str(tmp_path), "--device", "cpu",
    ])
    cfg = port_cfg(small_cfg(keyframe_interval=4, reloc_mode="forest"))
    res = trun.run_sequence(args, trun.image_inputs(args, cfg, port_intr(intr), cams, dark))
    records = res.records
    assert [r["frame"] for r in records] == list(range(1, 30))
    # the chunk starting after frame 8 ran twice: 8 frames, then 6 (to 14)
    assert [(f, t) for f, t, _, _ in calls][:3] == [(0, 8), (8, 8), (8, 6)]
    for _, _, before, state in calls:
        for a, b in zip(before, torch.utils._pytree.tree_leaves(state)):
            assert torch.equal(a, b)
    lost = [r["frame"] for r in records if r["lost"]]
    assert lost and set(lost) <= set(range(14, 17)), lost
    recovered = [r["frame"] for r in records if r["event"] == "reloc" and r["reloc_success"]]
    assert recovered and recovered[0] <= 16 + 2, recovered
    # every frame from the first lost one's successor to the recovery went
    # through the forest on the host
    assert res.forest_frames == list(range(lost[0] + 1, recovered[0] + 1)), res.forest_frames
    after = [r for r in records if r["frame"] > recovered[0]]
    assert all(r["event"] == "track" and not r["lost"] for r in after)
    pan_err = np.abs(np.array([r["pose"][0] for r in after]) - cams[[r["frame"] for r in after], 0])
    assert pan_err.mean() < 3e-3, pan_err.mean()
