"""The port's from-pixels main path against the JAX package's:
``PTZSlam.init`` + ``run_segment_pixels`` on the same 30 rendered frames
(tests/test_frontend.py's sequence), with the reference's own cadence and
with a keyframe every 6 frames (so keyframe insertion, map merge/cull and
the windowed BA run inside the loop)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax.frontend import extract_features as j_extract
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import frontend as tfront
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, render, small_cfg, t

torch.set_num_threads(2)

FRAMES = 30


def _run_port(cfg, intr, imgs, cam0):
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    frames = t(imgs)
    state = slam.init(*tfront.extract_features(frames[0], slam.cfg), cam0)
    state, infos = slam.run_segment_pixels(state, frames[1:])
    return slam, state, tslam.FrameInfo(*(n(v) for v in infos))


@pytest.mark.parametrize("keyframe_interval", [120, 6])
def test_slice_matches_reference(keyframe_interval):
    imgs, cams, intr = render(FRAMES, seed=1)
    cfg = small_cfg(keyframe_interval=keyframe_interval)
    jslam = JaxSlam(cfg, intr)
    jstate = jslam.init(*j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False), cams[0])
    jstate, jinfos = jslam.run_segment_pixels(jstate, jnp.asarray(imgs[1:]), use_pallas=False)
    ref = jax.device_get(jinfos)

    slam, state, got = _run_port(cfg, intr, imgs, cams[0])
    assert slam.cfg.descriptor_f_ref == jslam.cfg.descriptor_f_ref == float(cams[0][2])

    np.testing.assert_array_equal(got.lost, ref.lost)
    np.testing.assert_array_equal(got.event, ref.event)
    np.testing.assert_array_equal(got.keyframe, ref.keyframe)
    assert np.abs(got.num_matches.astype(int) - ref.num_matches.astype(int)).max() <= 2
    dpose = np.abs(got.pose - ref.pose)
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    assert int(state.kf.count) == int(jstate.kf.count)
    if keyframe_interval == 6:
        assert got.keyframe.sum() >= 3          # windowed BA ran in the loop
    # the port alone meets the reference test's ground-truth bound
    assert not got.lost.any()
    assert np.abs(got.pose[:, 0] - cams[1:, 0]).mean() < 2.5e-3


def test_skipped_frames_pass_state_through():
    imgs, cams, intr = render(FRAMES, seed=1)
    slam = tslam.PTZSlam(port_cfg(small_cfg()), port_intr(intr), device="cpu")
    frames = t(imgs[:6])
    state = slam.init(*tfront.extract_features(frames[0], slam.cfg), cams[0])
    ok = np.array([True, False, True, False, True])
    out, infos = slam.run_segment_pixels(state, frames[1:], frame_ok=ok)
    assert n(infos.event).tolist() == [0, 2, 0, 2, 0]
    assert int(out.frame_idx) == 3
    np.testing.assert_array_equal(n(infos.pose)[1], n(infos.pose)[0])
    rows = tslam.infos_to_dicts(infos, frame0=1)
    assert [r["frame"] for r in rows] == [1, 2, 3, 4, 5]
    assert [r["event"] for r in rows] == ["track", "reloc", "track", "reloc", "track"]
    one = tslam.info_to_dict(tslam.FrameInfo(*(v[0] for v in infos)))
    assert one["event"] == "track" and not one["lost"] and one["num_matches"] > 20
    np.testing.assert_array_equal(one["pose"], rows[0]["pose"])


def test_default_device_is_the_card(monkeypatch):
    """``PTZSlam`` with no device runs on the card; without CUDA it raises
    rather than falling back to the CPU."""
    cfg, intr = port_cfg(small_cfg()), port_intr(render(1, seed=1)[2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tslam.PTZSlam(cfg, intr)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tslam.PTZSlam(cfg, intr).device == torch.device("cuda")
    assert tslam.PTZSlam(cfg, intr, device="cpu").device == torch.device("cpu")


def test_numpy_and_host_inputs_match_the_tensor_run():
    """numpy frames, features, pose and masks go through ``device="cpu"``
    and give bitwise the run of the same CPU tensors."""
    imgs, cams, intr = render(FRAMES, seed=1)
    imgs = imgs[:8]
    frames = t(imgs)
    runs = []
    for as_numpy in (False, True):
        slam = tslam.PTZSlam(port_cfg(small_cfg()), port_intr(intr), device="cpu")
        feats = tfront.extract_features(frames[0], slam.cfg)
        if as_numpy:
            state = slam.init(*(n(v) for v in feats), np.asarray(cams[0]))
            out = slam.run_segment_pixels(state, imgs[1:], masks=np.ones(imgs[1:].shape, bool))
        else:
            state = slam.init(*feats, cams[0])
            out = slam.run_segment_pixels(state, frames[1:])
        runs.append(out)
    (s_t, i_t), (s_n, i_n) = runs
    assert not n(i_t.lost).any()
    for a, b in zip(i_t, i_n):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_array_equal(n(s_t.ekf.cam), n(s_n.ekf.cam))
