"""ptzjax_torch parity on the CPU for the host data layer: the synthetic
sequences (ray field, court model, movers), the synthetic feature adapter,
annotation I/O, the OpenCV frontend and the drawing helpers, each against
the JAX package's module on the same seeds. These are host numpy in both
packages, so every comparison is bitwise."""

import json

import numpy as np
import pytest
import torch

from ptzjax import features as jfeat
from ptzjax import io as jio
from ptzjax import synth as jsynth
from ptzjax import viz as jviz
from ptzjax.config import SLAMConfig
from ptzjax_torch import features as tfeat
from ptzjax_torch import geometry as tgeo
from ptzjax_torch import io as tio
from ptzjax_torch import synth as tsynth
from ptzjax_torch import viz as tviz
from ptzjax_torch.config import SLAMConfig as PortConfig
from tests._torch_port import port_cfg

torch.set_num_threads(2)

W, H = 640, 360


def _equal_trees(a, b):
    """Bitwise equality of two (nested) NamedTuples / tuples of arrays and
    scalars, dtypes included."""
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


class TestSequences:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(num_frames=20, num_rays=300, seed=0),
            dict(num_frames=12, num_rays=500, width=480.0, height=270.0, seed=4, pan_amp=0.2, period=30.0),
            dict(num_frames=8, num_rays=100, cx=300.0, cy=200.0, seed=7),
        ],
    )
    def test_make_sequence_bitwise(self, kw):
        _equal_trees(tsynth.make_sequence(**kw), jsynth.make_sequence(**kw))

    def test_make_ray_field_bitwise(self):
        _equal_trees(
            tsynth.make_ray_field(400, descriptor_dim=32, seed=3),
            jsynth.make_ray_field(400, descriptor_dim=32, seed=3),
        )

    @pytest.mark.parametrize(
        "kw",
        [dict(), dict(noise_px=1.0, outlier_frac=0.2, seed=2), dict(dropout_frac=0.3, seed=5)],
    )
    def test_render_frame_bitwise(self, kw):
        seq_t = tsynth.make_sequence(num_frames=10, num_rays=600, seed=1)
        seq_j = jsynth.make_sequence(num_frames=10, num_rays=600, seed=1)
        for frame in (0, 4, 9):
            _equal_trees(tsynth.render_frame(seq_t, frame, **kw), jsynth.render_frame(seq_j, frame, **kw))

    def test_render_sequence_padded_bitwise(self):
        seq_t = tsynth.make_sequence(num_frames=6, num_rays=900, seed=2)
        seq_j = jsynth.make_sequence(num_frames=6, num_rays=900, seed=2)
        # 64 < the visible count: the per-frame random subset is taken
        for max_obs in (64, 1000):
            _equal_trees(
                tsynth.render_sequence_padded(seq_t, max_obs, outlier_frac=0.1, seed=3),
                jsynth.render_sequence_padded(seq_j, max_obs, outlier_frac=0.1, seed=3),
            )

    @pytest.mark.parametrize("seed", [0, 3])
    def test_make_court_sequence_bitwise(self, seed):
        """Rays, cameras, intrinsics (center and base rotation) and the 3D
        points, for the CLI's --synthetic-court call."""
        kw = dict(num_frames=30, f0=1800.0, f_amp=150.0, period=45.0, seed=seed)
        (seq_t, pts_t), (seq_j, pts_j) = tsynth.make_court_sequence(**kw), jsynth.make_court_sequence(**kw)
        _equal_trees(seq_t, seq_j)
        np.testing.assert_array_equal(pts_t, pts_j)

    def test_look_at_rotation_orthonormal_and_forward(self):
        rb = tsynth.look_at_base_rotation((14.3, -18.0, 7.0), (14.3, 9.0, 0.0))
        np.testing.assert_array_equal(rb, jsynth.look_at_base_rotation((14.3, -18.0, 7.0), (14.3, 9.0, 0.0)))
        np.testing.assert_allclose(rb @ rb.T, np.eye(3), atol=1e-6)
        assert np.linalg.det(rb) > 0.99
        # the look target maps to the optical axis: theta = phi = 0
        d = rb @ (np.array([14.3, 9.0, 0.0]) - np.array([14.3, -18.0, 7.0]))
        assert abs(np.arctan2(d[0], d[2])) < 1e-6
        assert abs(np.arctan2(-d[1], np.hypot(d[0], d[2]))) < 1e-6

    def test_court_points_project_like_their_rays(self):
        """The port's rays_from_points on the court's 3D points equals the
        generator's host conversion, and projecting either gives the same
        pixels (tests/test_court.py on the port)."""
        seq, points = tsynth.make_court_sequence(num_frames=5, seed=1)
        rays = tgeo.rays_from_points(torch.from_numpy(points), seq.intr)
        np.testing.assert_allclose(rays.numpy(), seq.rays, atol=2e-5)
        cam = torch.from_numpy(seq.cameras[2])
        pix_a = tgeo.project_rays(cam, rays, seq.intr).numpy()
        pix_b = tgeo.project_rays(cam, torch.from_numpy(seq.rays), seq.intr).numpy()
        in_view = (np.abs(seq.rays[:, 0] - seq.cameras[2, 0]) < 0.6) & (
            np.abs(seq.rays[:, 1] - seq.cameras[2, 1]) < 0.6
        )
        assert np.abs(pix_a - pix_b)[in_view].max() < 0.15


@pytest.fixture(scope="module")
def movers():
    """tests/test_movers.py's scene: 8 blobs over a 640x360 sweep, both
    packages' generators."""
    kw = dict(num_blobs=8, theta_range=(-0.35, 0.35), phi_range=(-0.16, 0.0), ang_w=0.075, speed=0.006, seed=5)
    pano = tsynth.make_panorama(theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=5)
    cams = tsynth.make_trajectory(
        20, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=1100.0, f_amp=60.0, period=32.0, seed=5
    )
    intr = tgeo.Intrinsics.create(W / 2.0, H / 2.0)
    return tsynth.make_moving_blobs(20, **kw), jsynth.make_moving_blobs(20, **kw), pano, cams, intr


class TestMovers:
    def test_make_moving_blobs_bitwise(self, movers):
        _equal_trees(movers[0], movers[1])
        # the CLI's call (defaults, --movers 4)
        _equal_trees(tsynth.make_moving_blobs(12, num_blobs=4, seed=2), jsynth.make_moving_blobs(12, num_blobs=4, seed=2))

    def test_render_image_with_movers_bitwise(self, movers):
        mt, mj, pano, cams, intr = movers
        for k in (0, 7, 19):
            a = tsynth.render_image(pano, cams[k], intr, W, H, movers=mt, frame=k)
            b = jsynth.render_image(pano, cams[k], intr, W, H, movers=mj, frame=k)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)

    def test_mover_boxes_and_fraction_bitwise(self, movers):
        mt, mj, _, cams, intr = movers
        for k in range(0, 20, 3):
            bt = tsynth.mover_boxes(mt, k, cams[k], intr, W, H)
            np.testing.assert_array_equal(bt, jsynth.mover_boxes(mj, k, cams[k], intr, W, H))
            assert tsynth.mover_pixel_fraction(mt, k, cams[k], intr, W, H) == jsynth.mover_pixel_fraction(
                mj, k, cams[k], intr, W, H
            )
            np.testing.assert_array_equal(tio.boxes_to_mask(bt, H, W), jio.boxes_to_mask(bt, H, W))

    def test_mover_coverage_and_boxes(self, movers):
        """tests/test_movers.py:74-95 on the port: a real stress (>= 15% of
        the pixels on movers on average) whose boxes cover the blobs."""
        mt, _, pano, cams, intr = movers
        fracs = [tsynth.mover_pixel_fraction(mt, k, cams[k], intr, W, H) for k in range(len(cams))]
        assert np.mean(fracs) >= 0.15, np.mean(fracs)
        k = 10
        img = tsynth.render_image(pano, cams[k], intr, W, H, movers=mt, frame=k)
        clean = tsynth.render_image(pano, cams[k], intr, W, H)
        mask = tio.boxes_to_mask(tsynth.mover_boxes(mt, k, cams[k], intr, W, H), H, W)
        leaked = (np.abs(img - clean) > 1e-6) & mask
        assert leaked.mean() < 1e-3, leaked.mean()


class TestSynthFeatures:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(capacity=128),                                   # capacity < visible: salience subset
            dict(capacity=4000, noise_px=1.0, desc_noise=0.1),    # everything fits
            dict(capacity=256, outlier_frac=0.1, dropout_frac=0.2, seed=3),
        ],
    )
    def test_synth_features_bitwise(self, kw):
        seq_t = tsynth.make_sequence(num_frames=6, num_rays=2500, seed=0)
        seq_j = jsynth.make_sequence(num_frames=6, num_rays=2500, seed=0)
        for frame in (0, 5):
            (ft, it), (fj, ij) = tfeat.synth_features(seq_t, frame, **kw), jfeat.synth_features(seq_j, frame, **kw)
            _equal_trees(ft, fj)
            np.testing.assert_array_equal(it, ij)
            assert ft.capacity == fj.capacity == kw["capacity"]


class TestAnnotations:
    def _cams(self, n=20):
        rng = np.random.default_rng(0)
        return np.stack(
            [rng.normal(0.0, 0.3, n), rng.normal(-0.1, 0.05, n), rng.uniform(1500.0, 3000.0, n)], -1
        ).astype(np.float32)

    @pytest.mark.parametrize("writer", ["port", "ptzjax"])
    def test_npz_roundtrip_across_packages(self, tmp_path, writer):
        """An .npz written by either package loads the same in both."""
        cams = self._cams()
        names = [f"f{i:04d}.jpg" for i in range(20)]
        p = str(tmp_path / "ann.npz")
        if writer == "port":
            tio.save_annotations_npz(p, cams, tgeo.Intrinsics.create(640.0, 360.0, center=(1.0, 2.0, 3.0)), names)
        else:
            from ptzjax.geometry import Intrinsics

            jio.save_annotations_npz(p, cams, Intrinsics.create(640.0, 360.0, center=(1.0, 2.0, 3.0)), names)
        a, b = tio.load_annotations(p), jio.load_annotations(p)
        np.testing.assert_array_equal(a.cameras, cams)
        np.testing.assert_array_equal(a.cameras, b.cameras)
        for x, y in zip(a.intr, b.intr):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert a.image_names == b.image_names and len(a.image_names) == 20
        assert a.bboxes is None and b.bboxes is None

    def test_mat_plain_array_degrees(self, tmp_path):
        import scipy.io as sio

        cams_deg = np.stack([np.linspace(-30, 30, 10), np.full(10, -9.0), np.full(10, 3000.0)], -1)
        p = str(tmp_path / "seq.mat")
        sio.savemat(p, {"ptz": cams_deg})
        ann = tio.load_annotations(p)
        np.testing.assert_allclose(ann.cameras[:, 0], np.deg2rad(cams_deg[:, 0]), atol=1e-6)
        np.testing.assert_allclose(ann.cameras[:, 2], 3000.0)
        np.testing.assert_array_equal(ann.cameras, jio.load_annotations(p).cameras)

    @pytest.mark.parametrize("rotation", ["matrix", "rodrigues"])
    def test_mat_struct_records_and_meta(self, tmp_path, rotation):
        """The reference dataset's struct layout: per-frame records with ptz,
        image name and player boxes, and shared meta (principal point,
        camera center, base rotation as a matrix or a Rodrigues vector)."""
        import scipy.io as sio

        cams = np.stack([np.linspace(-20, 20, 5), np.full(5, -8.0), np.linspace(2000, 2400, 5)], -1)
        rec = np.zeros((5,), dtype=[("ptz", object), ("image_name", object), ("bounding_box", object)])
        for k in range(5):
            boxes = np.array([[10.0 * k, 20.0, 10.0 * k + 30, 60.0]] * (k % 3))
            rec[k] = (cams[k], f"img_{k:03d}.png", boxes if len(boxes) else np.zeros((0, 4)))
        r = np.array([0.1, -0.2, 0.05]) if rotation == "rodrigues" else np.eye(3)[[1, 0, 2]]
        meta = {"cc": np.array([320.0, 180.0]), "camera_center": np.array([1.0, -20.0, 8.0]), "base_rotation": r}
        p = str(tmp_path / "seq.mat")
        sio.savemat(p, {"annotation": rec, "meta": meta})
        a, b = tio.load_annotations(p), jio.load_annotations(p)
        np.testing.assert_array_equal(a.cameras, b.cameras)
        np.testing.assert_allclose(a.cameras[:, 0], np.deg2rad(cams[:, 0]), rtol=1e-6)
        for x, y in zip(a.intr, b.intr):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert float(a.intr.cx) == 320.0 and a.image_names == b.image_names
        assert [bb.shape for bb in a.bboxes] == [bb.shape for bb in b.bboxes] == [(0, 4), (1, 4), (2, 4), (0, 4), (1, 4)]
        for x, y in zip(a.bboxes, b.bboxes):
            np.testing.assert_array_equal(x, y)
        if rotation == "rodrigues":
            np.testing.assert_allclose(tio._rodrigues(r), jio._rodrigues(r), rtol=0, atol=0)
            rb = np.asarray(a.intr.base_rotation, np.float64)
            np.testing.assert_allclose(rb @ rb.T, np.eye(3), atol=1e-6)

    def test_boxes_to_mask(self):
        box = np.array([[10, 10, 20, 30]], np.float32)
        m = tio.boxes_to_mask(box, 64, 64, dilate=2)
        assert not m[15, 15] and not m[9, 9]  # inside + dilated rim
        assert m[40, 40] and m[2, 2]
        for dilate in (0, 2, 4):
            np.testing.assert_array_equal(
                tio.boxes_to_mask(box, 64, 64, dilate=dilate), jio.boxes_to_mask(box, 64, 64, dilate=dilate)
            )

    def test_jsonl_writer(self, tmp_path):
        recs = [{"frame": 0, "pose": np.array([1.0, 2.0, 3.0])}, {"frame": 1, "pose": np.zeros(3, np.float32), "lost": True}]
        pt, pj = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
        tio.write_trajectory_jsonl(pt, recs)
        jio.write_trajectory_jsonl(pj, recs)
        assert open(pt).read() == open(pj).read()
        assert json.loads(open(pt).readline())["pose"] == [1.0, 2.0, 3.0]


def _savemat(tmp_path, name, **kw):
    import scipy.io as sio

    p = str(tmp_path / name)
    sio.savemat(p, kw)
    return p


def _nan_at(arr, i, j):
    arr = arr.copy()
    arr[i, j] = np.nan
    return arr


# (case, writer, error type, message): tests/test_io_eval.py:198-287
_BAD = [
    ("mat missing annotation key", lambda d: _savemat(d, "a.mat", unrelated=np.ones((4, 3))), ValueError, "no annotation key"),
    ("mat wrong column count", lambda d: _savemat(d, "b.mat", annotation=np.ones((6, 2))), ValueError, r"\(T, 3\)"),
    (
        "mat non-finite values",
        lambda d: _savemat(d, "c.mat", annotation=_nan_at(np.tile([10.0, -5.0, 2000.0], (5, 1)), 3, 1)),
        ValueError, "non-finite",
    ),
    (
        "mat non-positive focal",
        lambda d: _savemat(d, "d.mat", annotation=np.where(np.arange(5)[:, None] == 2, [10.0, -5.0, 0.0], [10.0, -5.0, 2000.0])),
        ValueError, "focal",
    ),
    ("mat value count", lambda d: _savemat(d, "e.mat", annotation=np.ones(7)), ValueError, "multiple of 3"),
]


class TestAnnotationNegativePaths:
    @pytest.mark.parametrize("case", [c[0] for c in _BAD])
    def test_malformed_mat_raises_like_the_reference(self, tmp_path, case):
        _, write, err, match = next(c for c in _BAD if c[0] == case)
        p = write(tmp_path)
        with pytest.raises(err, match=match):
            jio.load_annotations(p)
        with pytest.raises(err, match=match):
            tio.load_annotations(p)

    def test_mat_degrees_detected_and_converted(self, tmp_path):
        p = _savemat(tmp_path, "e.mat", annotation=np.tile([25.0, -9.0, 2400.0], (4, 1)))
        ann = tio.load_annotations(p)
        np.testing.assert_allclose(ann.cameras[0, 0], np.deg2rad(25.0), rtol=1e-6)
        np.testing.assert_allclose(ann.cameras[0, 2], 2400.0)

    @pytest.mark.parametrize(
        "arrays, match",
        [(dict(cameras=np.tile([0.1, -0.05, 2000.0], (4, 1))), "missing keys"), (dict(cameras=np.ones((0, 3)), cx=640.0, cy=360.0), "non-empty")],
    )
    def test_npz_errors(self, tmp_path, arrays, match):
        p = str(tmp_path / "f.npz")
        np.savez(p, **arrays)
        with pytest.raises(ValueError, match=match):
            tio.load_annotations(p)

    def test_garbage_mat_file_raises(self, tmp_path):
        p = str(tmp_path / "h.mat")
        with open(p, "wb") as f:
            f.write(b"not a mat file at all" * 10)
        with pytest.raises(Exception):
            tio.load_annotations(p)

    def test_malformed_bboxes(self):
        with pytest.raises(ValueError, match=r"\(N, 4\)"):
            tio.boxes_to_mask(np.ones((3,)), 64, 64)


class TestSequenceManager:
    def test_images_masks_and_ptz(self, tmp_path):
        """Frames decoded by cv2 (the names from the annotation), ptz per
        frame, masks from the player boxes: equal to the reference's."""
        cv2 = pytest.importorskip("cv2")
        import scipy.io as sio

        rng = np.random.default_rng(1)
        rec = np.zeros((3,), dtype=[("ptz", object), ("image_name", object), ("bounding_box", object)])
        for k in range(3):
            cv2.imwrite(str(tmp_path / f"f{k}.png"), rng.integers(0, 256, (40, 60), dtype=np.uint8))
            rec[k] = (np.array([0.1 * k, -0.05, 1500.0]), f"f{k}.png", np.array([[5.0, 5.0, 20.0 + k, 15.0]]))
        ann = str(tmp_path / "seq.mat")
        sio.savemat(ann, {"annotation": rec})
        a, b = tio.SequenceManager(ann, str(tmp_path)), jio.SequenceManager(ann, str(tmp_path))
        assert a.length == b.length == 3
        for k in range(3):
            np.testing.assert_array_equal(a.get_image(k), b.get_image(k))
            np.testing.assert_array_equal(a.get_ptz(k), b.get_ptz(k))
            np.testing.assert_array_equal(a.get_mask(k, 40, 60), b.get_mask(k, 40, 60))
        assert a.get_image(0).dtype == np.float32 and not a.get_mask(1, 40, 60)[10, 10]
        # an .npz annotation has no boxes: no mask; names fall back to the listing
        tio.save_annotations_npz(str(tmp_path / "a.npz"), np.tile([0.0, 0.0, 1500.0], (3, 1)), tgeo.Intrinsics.create(30.0, 20.0))
        c = tio.SequenceManager(str(tmp_path / "a.npz"), str(tmp_path))
        assert c.get_mask(0, 40, 60) is None
        np.testing.assert_array_equal(c.get_image(2), b.get_image(2))


class TestViz:
    def test_draw_keypoints_marks_pixels(self):
        img = np.zeros((80, 120), np.float32)
        xy = np.array([[30.0, 40.0], [100.0, 10.0], [500.0, 500.0]])  # last out of bounds
        out = tviz.draw_keypoints(img, xy)
        assert out.shape == (80, 120, 3) and out.dtype == np.uint8
        assert (out[40, 30] != 0).any() and (out[10, 100] != 0).any()
        np.testing.assert_array_equal(out, jviz.draw_keypoints(img, xy))
        valid = np.array([True, False, True])
        np.testing.assert_array_equal(tviz.draw_keypoints(img, xy, valid), jviz.draw_keypoints(img, xy, valid))

    def test_draw_matches_side_by_side(self):
        a = np.random.default_rng(0).uniform(0, 1, (60, 90)).astype(np.float32)
        b = np.random.default_rng(1).uniform(0, 1, (60, 90)).astype(np.float32)
        xy_a = np.array([[10.0, 10.0], [50.0, 30.0]])
        xy_b = np.array([[12.0, 11.0], [52.0, 29.0]])
        out = tviz.draw_matches(a, xy_a, b, xy_b, np.array([True, True]))
        assert out.shape == (60, 180, 3)
        np.testing.assert_array_equal(out, jviz.draw_matches(a, xy_a, b, xy_b, np.array([True, True])))

    def test_draw_tracking_and_save(self, tmp_path):
        pytest.importorskip("matplotlib")
        img = np.zeros((50, 70), np.float32)
        obs = np.array([[20.0, 20.0], [40.0, 30.0]])
        pred = obs + 3.0
        out = tviz.draw_tracking(img, obs, pred, used=np.array([True, False]))
        np.testing.assert_array_equal(out, jviz.draw_tracking(img, obs, pred, used=np.array([True, False])))
        p = tviz.save_png(str(tmp_path / "t.png"), out)
        import os

        assert os.path.getsize(p) > 100
        assert (out != tviz.draw_tracking(img, obs, pred, used=np.array([True, True]))).any()


def _cv2_scene():
    """tests/test_frontend_cv2.py's pair: a 640x360 panorama render and the
    camera moved by (0.004, -0.001, 3)."""
    pano = tsynth.make_panorama(theta_range=(-0.5, 0.5), phi_range=(-0.3, 0.18), texels_per_rad=2200.0, seed=6)
    intr = tgeo.Intrinsics.create(W / 2.0, H / 2.0)
    cam0 = np.array([0.02, -0.04, 1100.0], np.float32)
    cam1 = cam0 + np.array([0.004, -0.001, 3.0], np.float32)
    return tsynth.render_image(pano, cam0, intr, W, H), tsynth.render_image(pano, cam1, intr, W, H), cam0, cam1, intr


class TestFrontendCv2:
    def test_extract_features_cv2_equals_reference(self):
        pytest.importorskip("cv2")
        from ptzjax.frontend_cv2 import extract_features_cv2 as j_extract
        from ptzjax_torch.frontend_cv2 import extract_features_cv2, has_cv2

        assert has_cv2()
        img = _cv2_scene()[0]
        cfg = SLAMConfig(max_keypoints=64, kf_desc_dim=128)
        mask = np.ones((H, W), bool)
        mask[:, : W // 2] = False
        for m in (None, mask):
            f = extract_features_cv2(img, port_cfg(cfg), mask=m)
            assert isinstance(f, tfeat.FrameFeatures)
            _equal_trees(tuple(f), tuple(j_extract(img, cfg, mask=m)))
            np.testing.assert_allclose(np.linalg.norm(f.desc[f.valid], axis=-1), 1.0, atol=1e-4)
        assert (f.xy[f.valid, 0] >= W // 2 - 1).all()
        with pytest.raises(ValueError, match="128-d"):
            extract_features_cv2(img, PortConfig(max_keypoints=64, kf_desc_dim=32))

    def test_track_features_cv2_equals_reference(self):
        """The cv2 KLT frontend: equal to the reference's, and the tracked
        points follow the true PTZ motion."""
        pytest.importorskip("cv2")
        from ptzjax.frontend_cv2 import track_features_cv2 as j_track
        from ptzjax_torch.frontend_cv2 import extract_features_cv2, track_features_cv2

        img0, img1, cam0, cam1, intr = _cv2_scene()
        cfg = PortConfig(max_keypoints=256)
        f0 = extract_features_cv2(img0, cfg)
        got = track_features_cv2(img0, img1, f0.xy, f0.desc, f0.valid, cfg)
        ref = j_track(img0, img1, f0.xy, f0.desc, f0.valid, SLAMConfig(max_keypoints=256))
        _equal_trees(tuple(got), tuple(ref))
        xy, _, _, tracked = got
        assert tracked.sum() > 0.5 * f0.valid.sum()
        rows = np.flatnonzero(tracked)
        rays = tgeo.back_project_pixels(torch.from_numpy(cam0), torch.from_numpy(f0.xy[rows]), intr)
        expect = tgeo.project_rays(torch.from_numpy(cam1), rays, intr).numpy()
        assert np.median(np.linalg.norm(expect - xy[rows], axis=-1)) < 1.0
