"""ptzjax_torch parity on the CPU for the windowed BA's firing branches: the
covariance-gated re-seed and the drift watchdog (tests/test_online_ba.py:
110-184). The JAX package tracks 100 oracle frames made by the port's
``synth`` / ``features`` (bitwise the reference's), its state is carried
into the port, the pan is biased, and the keyframe insert + windowed BA
then run in both packages."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import slam as jslam
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics
from ptzjax_torch import convert
from ptzjax_torch import features as tfeat
from ptzjax_torch import slam as tslam
from ptzjax_torch import synth as tsynth
from tests._torch_port import n, port_cfg, port_intr, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    """tests/test_online_ba.py's ``_tracked_state(online_iters=8)``: 100
    frames of a pan/zoom sweep over 2,500 rays with 32-d descriptors."""
    frames, seed = 100, 5
    cfg = SLAMConfig(
        max_rays=64, max_keypoints=128, max_map_rays=1024, max_keyframes=16, kf_desc_dim=32,
        sigma_obs=0.7, min_inliers=8, online_ba_iters=8, keyframe_overlap=0.75,
    )
    seq = tsynth.make_sequence(
        num_frames=frames, num_rays=2500, pan_amp=0.4, tilt_amp=0.03, f_amp=300.0,
        period=frames * 3.0, seed=seed,
    )
    d = np.random.default_rng(seed).normal(size=(2500, 32)).astype(np.float32)
    seq = seq._replace(descriptors=d / np.linalg.norm(d, axis=-1, keepdims=True))
    feats = [tfeat.synth_features(seq, k, cfg.max_keypoints, noise_px=0.5, desc_noise=0.05)[0] for k in range(frames)]
    intr = Intrinsics(*seq.intr)
    slam = jslam.PTZSlam(cfg, intr)
    state = slam.init(feats[0].xy, feats[0].desc, feats[0].valid, seq.cameras[0])
    xy, desc, valid = (np.stack([getattr(f, a) for f in feats[1:]]) for a in ("xy", "desc", "valid"))
    state, infos = slam.run_segment(state, xy, desc, valid)
    assert not np.asarray(infos.lost).any() and int(state.kf.count) >= 3
    return cfg, intr, jax.device_get(state), feats[-1]


@pytest.mark.parametrize("case, bias", [("healthy", 0.0), ("biased", 5e-3), ("drifted", 1e-2)])
def test_reseed_gate_and_drift_watchdog(tracked, case, bias):
    """Insert the current frame as a keyframe, then the windowed BA, on a
    healthy filter, one whose pan is biased by 5e-3 rad (the gate must
    re-seed from the BA pose and inflate the pose covariance) and one
    drifted by 1e-2 rad (past the watchdog's 5e-3 bound: LOST)."""
    cfg, intr, host, last = tracked
    cam = host.ekf.cam.copy()
    cam[0] += np.float32(bias)
    start = host._replace(ekf=host.ekf._replace(cam=cam))

    def insert_and_ba(s, *, cfg, intr):
        s = jslam._insert_keyframe(
            s, jnp.asarray(last.xy), jnp.asarray(last.desc), jnp.asarray(last.valid), cfg=cfg, intr=intr
        )
        return jslam._windowed_ba(s, cfg=cfg, intr=intr)

    want = jax.device_get(jax.jit(partial(insert_and_ba, cfg=cfg, intr=intr))(jax.tree_util.tree_map(jnp.asarray, start)))
    pc, pi = port_cfg(cfg), port_intr(intr)
    got = tslam._insert_keyframe(convert.state_from_jax_numpy(start, "cpu"), t(last.xy), t(last.desc), t(last.valid), cfg=pc, intr=pi)
    got = tslam._windowed_ba(got, cfg=pc, intr=pi)

    pose_t, pose_j = n(got.ekf.pose), np.asarray(want.ekf.cam[:3])
    np.testing.assert_allclose(pose_t[:2], pose_j[:2], atol=5e-4)
    np.testing.assert_allclose(pose_t[2], pose_j[2], atol=2.0)
    np.testing.assert_allclose(n(got.kf.poses)[:, :2], want.kf.poses[:, :2], atol=5e-4)
    assert bool(got.lost) == bool(want.lost) == (case == "drifted")
    moved_t, moved_j = abs(pose_t[0] - cam[0]), abs(pose_j[0] - cam[0])
    if case == "healthy":
        assert moved_t == moved_j == 0.0, "the gate must keep the EKF pose of a healthy filter"
    else:
        # both re-seed toward the pre-bias estimate and inflate the pose
        # covariance (cov[2, 2] is the focal variance: 25 px^2 after it)
        assert moved_t > 1e-3 and moved_j > 1e-3
        assert abs(pose_t[0] - host.ekf.cam[0]) < 0.5 * bias
        assert float(got.ekf.cov[2, 2]) > 1.0 and float(want.ekf.cov[2, 2]) > 1.0
        np.testing.assert_allclose(n(got.ekf.cov)[:3, :3], want.ekf.cov[:3, :3], rtol=1e-5, atol=1e-12)
