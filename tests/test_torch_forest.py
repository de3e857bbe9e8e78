"""ptzjax_torch's relocalization forest on the CPU: the native BTDTR forest
through the port's ctypes bridge (training, backtracking queries, async
training, save/load), forest-backed relocalization, and the loop's apply
step (``PTZSlam.apply_reloc_result``), mirroring tests/test_reloc_forest.py
and held against the JAX package where both compute the same thing."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ptzjax import slam as jslam
from ptzjax.config import SLAMConfig
from ptzjax_torch import convert
from ptzjax_torch import features as tfeat
from ptzjax_torch import mapstore as tmap
from ptzjax_torch import reloc as treloc
from ptzjax_torch import reloc_forest as rf
from ptzjax_torch import slam as tslam
from ptzjax_torch import synth as tsynth
from ptzjax_torch.config import SLAMConfig as PortConfig
from ptzjax_torch.geometry import Intrinsics
from tests._torch_port import n, port_cfg, port_intr, reference_forest_module

torch.set_num_threads(2)


def _sequence(seed=4, num_rays=900, dim=32, frames=60):
    seq = tsynth.make_sequence(num_frames=frames, num_rays=num_rays, seed=seed)
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(num_rays, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return seq._replace(descriptors=desc)


def _keyframes(seq, capacity=128):
    """(desc, rays, valid) of every 10th frame, from the port's features."""
    out = []
    for k in range(0, len(seq.cameras), 10):
        f, ids = tfeat.synth_features(seq, k, capacity, desc_noise=0.02)
        rays = np.where((ids >= 0)[:, None], seq.rays[np.clip(ids, 0, None)], 0.0).astype(np.float32)
        out.append((f.desc, rays, f.valid & (ids >= 0)))
    return out


@pytest.fixture(scope="module")
def trained():
    """Forest trained from 6 synthetic keyframes (tests/test_reloc_forest.py's)."""
    cfg = PortConfig(max_keypoints=128, kf_desc_dim=32)
    seq = _sequence()
    forest = rf.RelocForest(seed=7)
    for desc, rays, valid in _keyframes(seq):
        forest.add_keyframe(desc, rays, valid=valid)
    return forest, seq, cfg


class TestBuild:
    def test_library_builds_under_build_not_cpp(self):
        lib = rf.load()
        path = rf.library_path()
        assert lib._name == str(path) and path.exists()
        assert path.parent == Path(rf.BUILD_DIR)
        assert path.parent.parts[-2:] == ("build", "ptzjax_torch")
        assert rf.SOURCE.parts[-3:] == ("cpp", "reloc_forest", "reloc_forest.cpp")

    def test_source_change_rebuilds_and_a_failed_build_raises(self, tmp_path, monkeypatch):
        src = tmp_path / "reloc_forest.cpp"
        src.write_text(rf.SOURCE.read_text())
        monkeypatch.setattr(rf, "SOURCE", src)
        monkeypatch.setattr(rf, "BUILD_DIR", tmp_path / "out")
        before = rf.library_path()
        src.write_text(src.read_text() + "\n// edited\n")
        assert rf.library_path() != before and not rf.library_path().exists()
        src.write_text("this is not C++\n")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            rf.build()
        assert not any((tmp_path / "out").glob("*.so"))


class TestForestRegression:
    def test_training_accumulates(self, trained):
        forest, _, _ = trained
        assert forest.num_samples > 300

    def test_predicts_rays_near_gt(self, trained):
        forest, seq, cfg = trained
        f, ids = tfeat.synth_features(seq, 25, cfg.max_keypoints, desc_noise=0.02, seed=1)
        keep = np.asarray(f.valid) & (ids >= 0)
        pred = forest.predict(f.desc[keep])
        err = np.linalg.norm(pred.rays - seq.rays[ids[keep]], axis=-1)
        confident = pred.conf > 0.55
        assert confident.mean() > 0.5
        assert np.median(err[confident]) < 5e-3, np.median(err[confident])

    def test_untrained_predict_raises(self):
        with pytest.raises(RuntimeError, match="not trained"):
            rf.RelocForest().predict(np.zeros((3, 32), np.float32))

    def test_save_load_roundtrip(self, trained, tmp_path):
        forest, seq, cfg = trained
        p = str(tmp_path / "forest.bin")
        forest.save(p)
        back = rf.RelocForest.load(p)
        assert back.num_samples == forest.num_samples
        f, _ = tfeat.synth_features(seq, 33, cfg.max_keypoints, seed=2)
        np.testing.assert_array_equal(forest.predict(f.desc).rays, back.predict(f.desc).rays)
        with pytest.raises(IOError, match="cannot read"):
            rf.RelocForest.load(str(tmp_path / "missing.bin"))


class TestForestRelocalization:
    def test_recovers_lost_pose(self, trained):
        forest, seq, cfg = trained
        frame = 37  # not a training keyframe
        f, _ = tfeat.synth_features(seq, frame, cfg.max_keypoints, desc_noise=0.02, seed=3)
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))
        res = rf.relocalize_rf(forest, f.desc, f.xy, f.valid, intr, cfg, device="cpu")
        assert bool(res.success), int(res.inliers)
        assert res.pose.device.type == "cpu"
        pose, gt = n(res.pose), seq.cameras[frame]
        assert abs(pose[0] - gt[0]) < 2e-3 and abs(pose[1] - gt[1]) < 2e-3 and abs(pose[2] - gt[2]) < 30.0

    def test_parity_with_map_path(self, trained):
        """The forest and the map backend recover the same pose."""
        forest, seq, cfg = trained
        frame = 44
        f, _ = tfeat.synth_features(seq, frame, cfg.max_keypoints, desc_noise=0.02, seed=5)
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))
        cfg_store = cfg.replace(max_map_rays=1024)
        m, nr = cfg_store.max_map_rays, len(seq.rays)
        rays = torch.zeros((m, 2))
        rays[:nr] = torch.from_numpy(seq.rays)
        desc = torch.zeros((m, 32))
        desc[:nr] = torch.from_numpy(seq.descriptors)
        store = tmap.init_ray_store(cfg_store, device="cpu")._replace(rays=rays, desc=desc, valid=torch.arange(m) < nr)
        res_map = treloc.relocalize(
            torch.from_numpy(f.desc), torch.from_numpy(f.xy), torch.from_numpy(f.valid), store, intr, cfg_store
        )
        res_rf = rf.relocalize_rf(forest, f.desc, f.xy, f.valid, intr, cfg, device="cpu")
        assert bool(res_map.success) and bool(res_rf.success)
        a, b = n(res_map.pose), n(res_rf.pose)
        assert abs(a[0] - b[0]) < 2e-3 and abs(a[1] - b[1]) < 2e-3 and abs(a[2] - b[2]) < 40.0

    def test_numpy_inputs_go_to_the_card_by_default(self, trained):
        """Without ``device`` and with numpy inputs the solve runs on the
        card; without one it raises instead of falling back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is the card")
        forest, seq, cfg = trained
        f, _ = tfeat.synth_features(seq, 37, cfg.max_keypoints)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rf.relocalize_rf(forest, f.desc, f.xy, f.valid, seq.intr, cfg)


class TestAsyncTraining:
    """Background (native-thread) training: keyframe-time stalls bounded by
    the sample copy, not the tree rebuild."""

    def _data(self, n, dim=32, seed=11):
        rng = np.random.default_rng(seed)
        desc = rng.normal(size=(n, dim)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        return desc, rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)

    def test_async_matches_sync_predictions(self):
        desc, rays = self._data(3000)
        q, _ = self._data(64, seed=12)
        f_sync = rf.RelocForest(seed=5)
        f_sync.add_keyframe(desc, rays)
        f_async = rf.RelocForest(seed=5, async_train=True)
        f_async.add_keyframe(desc, rays)
        f_async.wait()
        p_s, p_a = f_sync.predict(q), f_async.predict(q)
        np.testing.assert_array_equal(p_s.rays, p_a.rays)
        np.testing.assert_array_equal(p_s.conf, p_a.conf)

    def test_async_add_does_not_stall(self):
        import time

        desc, rays = self._data(4000)
        f = rf.RelocForest(async_train=True)
        t0 = time.perf_counter()
        f.add_keyframe(desc, rays)
        dt = time.perf_counter() - t0
        assert f.training or f.num_samples == 4000
        f.wait()
        assert dt < 0.05, f"async add_keyframe stalled {dt * 1e3:.0f} ms"
        q, _ = self._data(16, seed=13)
        assert len(f.predict(q).rays) == 16

    def test_queries_serve_old_trees_during_build(self):
        desc, rays = self._data(2000)
        f = rf.RelocForest(async_train=True)
        f.add_keyframe(desc, rays)
        f.wait()
        q, _ = self._data(32, seed=14)
        before = f.predict(q)
        more_d, more_r = self._data(3000, seed=15)
        f.add_keyframe(more_d, more_r)   # triggers a background rebuild
        during = f.predict(q)            # served concurrently
        np.testing.assert_array_equal(before.rays, during.rays)
        f.wait()
        assert f.predict(q).rays.shape == before.rays.shape

    def test_untrained_async_reloc_reports_failure(self):
        f = rf.RelocForest(async_train=True)
        desc, _ = self._data(64, seed=16)
        res = rf.relocalize_rf(
            f, desc, np.zeros((64, 2), np.float32), np.ones(64, bool), Intrinsics.create(640.0, 360.0),
            PortConfig(kf_desc_dim=32), device="cpu",
        )
        assert not bool(res.success) and int(res.inliers) == 0
        assert res.matched_ok.shape == (64,) and not bool(res.matched_ok.any())


# --- against the JAX package ---------------------------------------------------


def test_forest_predictions_equal_the_reference():
    """Both packages' forests (the same source, compiled by each package's
    build) trained on the same keyframes with the same seed predict the same
    rays and confidences."""
    jrf = reference_forest_module()
    seq = _sequence(seed=2)
    port, ref = rf.RelocForest(seed=7), jrf.RelocForest(seed=7)
    for desc, rays, valid in _keyframes(seq):
        assert port.add_keyframe(desc, rays, valid=valid) == ref.add_keyframe(desc, rays, valid=valid)
    assert port.num_samples == ref.num_samples
    f, _ = tfeat.synth_features(seq, 27, 128, desc_noise=0.02, seed=4)
    a, b = port.predict(f.desc), ref.predict(f.desc)
    np.testing.assert_array_equal(a.rays, b.rays)
    np.testing.assert_array_equal(a.conf, b.conf)


@pytest.fixture(scope="module")
def lost_scene():
    """A JAX state after 40 tracked synthetic frames (keyframes every 8),
    both packages' forests trained on its keyframes as the CLI trains them,
    and a later frame's features: the forest path's inputs."""
    jrf = reference_forest_module()
    cfg = SLAMConfig(
        max_rays=64, max_keypoints=128, max_map_rays=1024, max_keyframes=16, kf_desc_dim=32,
        sigma_obs=0.7, min_inliers=8, keyframe_interval=8,
    )
    seq = tsynth.make_sequence(
        num_frames=60, num_rays=2500, pan_amp=0.4, tilt_amp=0.03, f_amp=300.0, period=180.0, seed=5
    )
    rng = np.random.default_rng(5)
    d = rng.normal(size=(2500, 32)).astype(np.float32)
    seq = seq._replace(descriptors=d / np.linalg.norm(d, axis=-1, keepdims=True))
    feats = [tfeat.synth_features(seq, k, cfg.max_keypoints)[0] for k in range(60)]
    slam = jslam.PTZSlam(cfg, seq.intr)
    state = slam.init(*feats[0], seq.cameras[0])
    xy, desc, valid = (np.stack([getattr(f, a) for f in feats[1:40]]) for a in ("xy", "desc", "valid"))
    state, infos = slam.run_segment(state, xy, desc, valid)
    host = jax.device_get(state)
    assert not np.asarray(infos.lost).any() and int(host.kf.count) >= 4
    forests = rf.RelocForest(seed=17), jrf.RelocForest(seed=17)
    for i in range(int(host.kf.count)):
        keep = host.kf.feat_valid[i] & (host.kf.ray_ids[i] >= 0)
        rays = host.rays.rays[np.clip(host.kf.ray_ids[i], 0, None)]
        for forest in forests:
            forest.add_keyframe(host.kf.desc[i], rays, valid=keep)
    return cfg, seq, slam, host, state, forests, jrf, feats[46]


def test_relocalize_rf_matches_the_reference(lost_scene):
    cfg, seq, _, _, _, (port, ref), jrf, f = lost_scene
    got = rf.relocalize_rf(port, f.desc, f.xy, f.valid, port_intr(seq.intr), port_cfg(cfg), device="cpu")
    want = jrf.relocalize_rf(ref, f.desc, f.xy, f.valid, seq.intr, cfg)
    assert bool(got.success) and bool(want.success)
    np.testing.assert_allclose(n(got.pose)[:2], n(want.pose)[:2], atol=5e-4)
    np.testing.assert_allclose(n(got.pose)[2], n(want.pose)[2], atol=2.0)
    assert abs(int(got.inliers) - int(want.inliers)) <= 2
    err = np.abs(n(got.pose) - seq.cameras[46])
    assert err[0] < 2e-3 and err[1] < 2e-3 and err[2] < 30.0, err


@pytest.mark.parametrize("success", [True, False])
def test_apply_reloc_result_matches_the_reference(lost_scene, success):
    """The apply step on the same lost state and the same forest result: on
    success a fresh filter at the pose with the inliers back-projected into
    slots and map rays (deduplicated against the map), on failure only the
    frame count moves, in both packages."""
    cfg, seq, slam, host, state, (_, ref), jrf, f = lost_scene
    res = jax.device_get(jrf.relocalize_rf(ref, f.desc, f.xy, f.valid, seq.intr, cfg))
    assert bool(res.success)
    res = res._replace(success=np.asarray(success))
    lost = state._replace(lost=np.asarray(True))
    want = jax.device_get(slam.apply_reloc_result(lost, f.xy, f.desc, f.valid, res))
    port = tslam.PTZSlam(port_cfg(cfg), port_intr(seq.intr), device="cpu")
    start = convert.state_from_jax_numpy(host, "cpu")._replace(lost=torch.tensor(True))
    got = port.apply_reloc_result(start, f.xy, f.desc, f.valid, treloc.RelocResult(*res))
    got = convert.state_to_numpy(got)
    assert bool(got.lost) == bool(want.lost) == (not success)
    assert int(got.frame_idx) == int(want.frame_idx) == int(host.frame_idx) + 1
    for name in ("cam", "active", "ray_ids", "missed", "rej"):
        np.testing.assert_array_equal(getattr(got.ekf, name), getattr(want.ekf, name), err_msg=name)
    # the inserted rays' covariance blocks: fp32 products in another order
    np.testing.assert_allclose(got.ekf.cov, want.ekf.cov, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(got.ekf.rays, want.ekf.rays, atol=1e-6)
    np.testing.assert_allclose(got.slot_desc, want.slot_desc, atol=1e-6)
    for name in ("valid", "views", "count", "last_seen"):
        np.testing.assert_array_equal(getattr(got.rays, name), getattr(want.rays, name), err_msg=name)
    np.testing.assert_allclose(got.rays.rays, want.rays.rays, atol=1e-6)
    np.testing.assert_allclose(got.rays.desc, want.rays.desc, atol=1e-6)
    if success:
        assert got.ekf.active.sum() >= cfg.reloc_min_matches
        np.testing.assert_array_equal(got.ekf.cam[:3], n(res.pose))
    else:
        np.testing.assert_array_equal(got.ekf.cam, host.ekf.cam)
