"""The homography-EKF baseline and its RANSAC (``ptzjax_torch.baselines``,
``match.ransac_pan_tilt``, ``_prng``) against the reference on the CPU.

The RANSAC's hypotheses are ``jax.random.randint`` draws: the port's numpy
threefry must give them bit for bit, and then the inlier mask is the
reference's. The baseline at tests/test_baselines.py's configuration must
take the reference's per-frame decisions (accepted flags and inlier counts
equal, poses within 5e-4 rad / 2 px), and the port's own SLAM must beat the
port's baseline as the reference's does (the paper's drift comparison)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import match as jmatch
from ptzjax.baselines import init_vo, track_homography_ekf
from ptzjax.geometry import Intrinsics, project_rays
from ptzjax_torch import _prng
from ptzjax_torch import baselines as tbase
from ptzjax_torch import match as tmatch
from ptzjax_torch.slam import PTZSlam
from tests._torch_port import n, port_cfg, port_intr, t
from tests.test_baselines import CFG, make_features

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "seed, h, q",
    [(0, 128, 512), (0, 64, 192), (3, 64, 1000), (7, 200, 97), (123456, 32, 3), (5, 64, 70000), (0, 16, 1)],
)
def test_randint_equals_jax(seed, h, q):
    """``jax.random.randint(PRNGKey(seed), (h,), 0, q)``, bit for bit, for
    powers of 2 and not, spans above 2^16 (the multiplier wraps) and 1."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (h,), 0, q))
    got = _prng.randint(_prng.prng_key(seed), h, 0, q)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert _prng.ransac_picks(seed, h, q) == tuple(int(v) for v in want)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_split_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _prng.split(_prng.prng_key(seed), 3) == [tuple(int(v) for v in k) for k in np.asarray(jax.random.split(key, 3))]
    want = np.asarray(jax.random.bits(key, (9,), jnp.uint32))
    assert np.array_equal(_prng.random_bits32(_prng.prng_key(seed), 9), want)


def _ransac_case(num_hypotheses=64, outliers=20, seed=0):
    """tests/test_io_eval.py's case: 80 rays seen from (0.15, -0.05, 2200)
    with 0.5 px noise, ``outliers`` of them replaced by uniform pixels."""
    rng = np.random.default_rng(seed)
    intr = Intrinsics.create(640.0, 360.0)
    cam = np.array([0.15, -0.05, 2200.0], np.float32)
    rays = np.stack([rng.uniform(0.0, 0.3, 80), rng.uniform(-0.15, 0.02, 80)], -1).astype(np.float32)
    pix = np.asarray(project_rays(jnp.asarray(cam), jnp.asarray(rays), intr))
    pix = (pix + rng.normal(0, 0.5, pix.shape)).astype(np.float32)
    bad = np.zeros(80, bool)
    bad[rng.choice(80, outliers, replace=False)] = True
    pix = np.where(bad[:, None], rng.uniform(0, 1000, (80, 2)).astype(np.float32), pix)
    return rays, pix, cam, bad


@pytest.mark.parametrize("num_hypotheses, ok_frac, seed", [(64, 1.0, 0), (128, 0.7, 1), (17, 0.3, 2)])
def test_ransac_pan_tilt_mask_equals_reference(num_hypotheses, ok_frac, seed):
    """The same inlier mask as ``ptzjax.match.ransac_pan_tilt``, with all
    candidates valid (test_io_eval.py's case) and with some invalid (the
    picks that land on them fall back to the first valid vote)."""
    rays, pix, cam, bad = _ransac_case(seed=seed)
    ok = np.random.default_rng(seed + 10).random(80) < ok_frac
    ok[np.flatnonzero(ok)[:1]] = True
    want = np.asarray(jmatch.ransac_pan_tilt(
        jnp.asarray(rays), jnp.asarray(pix), jnp.asarray(ok), jnp.asarray(cam[2]), 640.0, 360.0,
        num_hypotheses=num_hypotheses, inlier_px=3.0, seed=seed,
    ))
    got = n(tmatch.ransac_pan_tilt(
        t(rays), t(pix), t(ok), torch.tensor(cam[2]), 640.0, 360.0,
        num_hypotheses=num_hypotheses, inlier_px=3.0, seed=seed,
    ))
    assert np.array_equal(got, want)
    if ok_frac == 1.0:
        # all kept matches are true inliers, most true inliers kept
        assert not (got & bad).any() and got[~bad].mean() > 0.9


def _run_port_baseline(seq, xy, desc, valid):
    state = tbase.init_vo(seq.cameras[0], xy[0], desc[0], valid[0], port_cfg(CFG), device="cpu")
    return tbase.track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=port_intr(seq.intr), cfg=port_cfg(CFG))


def test_track_homography_ekf_matches_reference():
    """test_baselines.py's CFG, T = 40: the accepted flags and inlier counts
    equal, poses within 5e-4 rad and 2 px, and the short horizon tracked."""
    seq, xy, desc, valid = make_features(T=40)
    state = init_vo(seq.cameras[0], xy[0], desc[0], valid[0], CFG)
    _, want = track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=seq.intr, cfg=CFG)
    final, got = _run_port_baseline(seq, xy, desc, valid)
    assert np.array_equal(n(got.updated), np.asarray(want.updated))
    assert np.array_equal(n(got.num_inliers), np.asarray(want.num_inliers))
    d = np.abs(n(got.pose) - np.asarray(want.pose))
    assert d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, d.max(0)
    assert final.cov.shape == (6, 6) and torch.equal(final.xy, torch.as_tensor(xy[-1]))
    err = np.abs(n(got.pose) - seq.cameras[1:])
    assert (n(got.num_inliers)[:10] > CFG.min_inliers).all()
    assert err[:20, 0].mean() < 5e-3 and err[:20, 2].mean() < 60.0


def test_slam_beats_homography_baseline():
    """tests/test_baselines.py's comparison, with the port on both sides:
    300 frames with 1.5 px noise. The baseline stays sane but drifts; the
    keyframe + map system stays bounded."""
    seq, xy, desc, valid = make_features(T=300, noise=1.5)
    _, base = _run_port_baseline(seq, xy, desc, valid)
    base_pose = n(base.pose)
    base_err = np.abs(base_pose - seq.cameras[1:])

    slam = PTZSlam(port_cfg(CFG), port_intr(seq.intr), device="cpu")
    state = slam.init(xy[0], desc[0], valid[0], seq.cameras[0])
    _, infos = slam.run_segment(state, xy[1:], desc[1:], valid[1:])
    slam_err = np.abs(n(infos.pose) - seq.cameras[1:])
    assert not n(infos.lost).any()

    assert np.isfinite(base_pose).all() and base_err[:, 0].mean() < 0.05
    late, early = base_err[250:, 0].mean(), base_err[:30, 0].mean()
    assert late > 5.0 * early, (early, late)
    assert slam_err[:, 0].mean() < base_err[:, 0].mean() / 3.0, (slam_err[:, 0].mean(), base_err[:, 0].mean())
    assert slam_err[250:, 0].mean() < late / 5.0, (slam_err[250:, 0].mean(), late)
