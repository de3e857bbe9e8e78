"""Checkpoints across packages and the run report, on the CPU.

A ``ptzjax`` checkpoint resumes in the port and the port's next frames match
the JAX run (flags equal, poses within 5e-4 rad and 2 px: the slice test's
tolerance); a port checkpoint loads in ``ptzjax`` with bitwise-equal leaves;
the three refusals raise. ``eval.trajectory_errors`` / ``reprojection_rmse``
/ ``evaluate_run`` equal the JAX package's to 1e-6 relative (fp32 sums in
another order), but for ``evaluate_run``'s reprojection RMSE of a run whose
poses are ~0.1 px off: both packages are held to its float64 value within
the fp32 bound derived in ``test_evaluate_run_matches``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import ba as jba
from ptzjax import checkpoint as jckpt
from ptzjax import eval as jeval
from ptzjax import mapstore as jmap
from ptzjax import slam as jslam
from ptzjax.frontend import extract_features as j_extract
from ptzjax_torch import ba as tba
from ptzjax_torch import checkpoint as tckpt
from ptzjax_torch import eval as teval
from ptzjax_torch import frontend as tfront
from ptzjax_torch import mapstore as tmap
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, render, small_cfg, t

torch.set_num_threads(2)

FRAMES = 20
SPLIT = 10


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's 20-frame re-detect run in two chunks of 10, with a
    checkpoint written between them."""
    imgs, cams, intr = render(FRAMES + 1, seed=1)
    cfg = small_cfg(keyframe_interval=6)
    slam = jslam.PTZSlam(cfg, intr)
    state = slam.init(*j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False), cams[0])
    mid, infos_a = slam.run_segment_pixels(state, jnp.asarray(imgs[1 : SPLIT + 1]), use_pallas=False)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_state.npz")
    jckpt.save_pytree(path, mid)
    end, infos_b = slam.run_segment_pixels(mid, jnp.asarray(imgs[SPLIT + 1 :]), use_pallas=False)
    infos = jax.tree_util.tree_map(lambda a, b: np.concatenate([a, b]), *jax.device_get((infos_a, infos_b)))
    return imgs, cams, intr, slam.cfg, path, mid, infos


def _fresh_port_state(slam, imgs, cams):
    return slam.init(*tfront.extract_features(t(imgs[0]), slam.cfg), cams[0])


def test_structure_string_is_ptzjax_s(jax_run):
    """The port writes the structure string ``str(treedef)`` gives for the
    same tree, for the state, a BA problem, the LM carry and plain tuples."""
    imgs, cams, intr, cfg, _, mid, _ = jax_run
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    port_state = _fresh_port_state(slam, imgs, cams)
    assert tckpt.tree_flatten(port_state)[1] == str(jax.tree_util.tree_structure(mid))
    prob_j = jmap.build_ba_problem(mid.kf, mid.rays, 4)
    prob_t = tmap.build_ba_problem(port_state.kf, port_state.rays, 4)
    assert tckpt.tree_flatten(prob_t)[1] == str(jax.tree_util.tree_structure(prob_j))
    lm_j = jba.init_lm_state(prob_j, intr, cfg)
    lm_t = tba.init_lm_state(prob_t, port_intr(intr), port_cfg(cfg))
    leaves, structure = tckpt.tree_flatten((lm_t, (port_state.lost,), port_state.frame_idx))
    assert structure == str(jax.tree_util.tree_structure((lm_j, (mid.lost,), mid.frame_idx)))
    assert len(leaves) == len(jax.tree_util.tree_leaves((lm_j, (mid.lost,), mid.frame_idx))) == 8


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    imgs, cams, intr, cfg, path, mid, ref = jax_run
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    like = _fresh_port_state(slam, imgs, cams)
    state = tckpt.load_pytree(path, like)
    assert isinstance(state, tslam.SlamState) and isinstance(state.kf, tmap.KeyframeStore)
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(mid)), tckpt.tree_flatten(state)[0]):
        assert b.device.type == "cpu" and n(b).dtype == a.dtype
        np.testing.assert_array_equal(n(b), a)
    state, infos = slam.run_segment_pixels(state, t(imgs[SPLIT + 1 :]))
    got = tslam.FrameInfo(*(n(v) for v in infos))
    np.testing.assert_array_equal(got.lost, ref.lost[SPLIT:])
    np.testing.assert_array_equal(got.event, ref.event[SPLIT:])
    np.testing.assert_array_equal(got.keyframe, ref.keyframe[SPLIT:])
    assert got.keyframe.any() and not got.lost.any()
    dpose = np.abs(got.pose - ref.pose[SPLIT:])
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)


def test_port_checkpoint_loads_in_ptzjax_bitwise(jax_run, tmp_path):
    imgs, cams, intr, cfg, _, mid, _ = jax_run
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    state, _ = slam.run_segment_pixels(_fresh_port_state(slam, imgs, cams), t(imgs[1:4]))
    path = str(tmp_path / "port_state.npz")
    tckpt.save_pytree(path, state)
    loaded = jckpt.load_pytree(path, mid)
    assert type(loaded).__name__ == "SlamState"
    port_leaves = tckpt.tree_flatten(state)[0]
    jax_leaves = jax.tree_util.tree_leaves(loaded)
    assert len(port_leaves) == len(jax_leaves) == 24
    for a, b in zip(port_leaves, jax_leaves):
        assert n(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(b), n(a))
    # and back into the port, bitwise
    again = tckpt.load_pytree(path, state)
    for a, b in zip(port_leaves, tckpt.tree_flatten(again)[0]):
        assert torch.equal(a, b)


def test_refusals_raise(jax_run, tmp_path):
    """Layout version, structure and leaf shape: each mismatch is refused."""
    imgs, cams, intr, cfg, path, _, _ = jax_run
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    like = _fresh_port_state(slam, imgs, cams)

    with np.load(path) as d:
        arrays = dict(d)
    old = str(tmp_path / "v1.npz")
    np.savez(old, **{k: v for k, v in arrays.items() if k != "__layout_version__"})
    with pytest.raises(ValueError, match="layout version 1"):
        tckpt.load_pytree(old, like)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_pytree(path, (like.ekf, like.kf))
    small = tslam.PTZSlam(port_cfg(cfg.replace(max_keyframes=8)), port_intr(intr), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(path, _fresh_port_state(small, imgs, cams))


def test_save_accepts_a_path_without_the_suffix(tmp_path):
    """As ``np.savez`` (and ``ptzjax``): ``.npz`` is appended."""
    tree = (torch.arange(3), (torch.ones(2, 2, dtype=torch.bool),))
    tckpt.save_pytree(str(tmp_path / "plain"), tree)
    assert os.path.exists(tmp_path / "plain.npz")
    back = tckpt.load_pytree(str(tmp_path / "plain.npz"), tree)
    assert torch.equal(back[0], tree[0]) and torch.equal(back[1][0], tree[1][0])


# --- eval ---------------------------------------------------------------------


def test_trajectory_errors_and_reprojection_rmse_match(jax_run):
    _, cams, intr, _, _, _, ref = jax_run
    gt = cams[1:]
    pred = ref.pose + np.random.default_rng(0).normal(scale=[2e-3, 1e-3, 5.0], size=ref.pose.shape).astype(np.float32)
    a, b = teval.trajectory_errors(pred, gt), jeval.trajectory_errors(pred, gt)
    assert a.as_dict() == b.as_dict()
    pi = port_intr(intr)
    for rays in (None, np.random.default_rng(1).uniform([-0.1, -0.1], [0.1, 0.0], (50, 2)).astype(np.float32)):
        got = teval.reprojection_rmse(pred, gt, pi, 640, 360, rays=rays, device="cpu")
        want = jeval.reprojection_rmse(pred, gt, intr, 640, 360, rays=rays)
        assert got > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _reprojection_rmse_f64(pred, gt, cx, cy, width, height, grid=12):
    """``eval.reprojection_rmse`` with its default grid rays, in float64
    numpy from the same float32 inputs: the value both packages round."""
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    gx, gy = np.meshgrid(np.linspace(0.05 * width, 0.95 * width, grid), np.linspace(0.05 * height, 0.95 * height, grid))
    px, py = gx.reshape(-1), gy.reshape(-1)
    per_frame, coords = [], 0
    for cp, cg in zip(pred, gt):
        u = np.arctan2(px - cx, cg[2])
        theta, phi = cg[0] + u, cg[1] + np.arctan2(-(py - cy) * np.cos(u), cg[2])

        def project(c):
            uu, vv = np.clip(theta - c[0], -1.5, 1.5), np.clip(phi - c[1], -1.5, 1.5)
            return c[2] * np.tan(uu) + cx, -c[2] * np.tan(vv) / np.cos(uu) + cy

        (ax, ay), (bx, by) = project(cp), project(cg)
        ok = (bx >= -1) & (bx < width + 1) & (by >= -1) & (by < height + 1)
        per_frame.append(((ax - bx) ** 2 + (ay - by) ** 2)[ok].sum() / max(ok.sum(), 1))
        coords += 2 * int(ok.sum())
    return float(np.sqrt(np.mean(per_frame))), coords


def test_evaluate_run_matches(jax_run, monkeypatch):
    _, cams, intr, _, _, _, ref = jax_run
    infos_t = tslam.FrameInfo(*(t(v) for v in ref))
    got = teval.evaluate_run(infos_t, cams, port_intr(intr), 640, 360)
    want = jeval.evaluate_run(jslam.FrameInfo(*ref), cams, intr, 640, 360)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k != "reprojection_rmse_px":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    # reprojection_rmse_px is the RMS of project(pred) - project(gt), two
    # projections of some 600 px whose difference is ~0.1 px: fp32 cannot
    # hold it to 1e-6 relative, and each package rounds it its own way (XLA
    # contracts multiply-adds by the CPU's features). Both are held to the
    # float64 value of the same inputs instead, within the fp32 bound:
    #  * a projected coordinate (x = f tan(u) + cx, y = -f tan(v) / cos(u)
    #    + cy, |x|, |y| < 640 px, f < 1,100 px, |u|, |v| < 0.3) carries at
    #    most ~4,200 unit roundoffs u = 2**-24 of error: the angle
    #    difference ~360, tan and cos at 4 ulps each ~2,700 and ~1,600 (x and
    #    y), the product, quotient and sum ~1,000. One coordinate of the
    #    difference a - b of two projections: DELTA = 2 * 4,200 u = 5.0e-4 px.
    #  * the RMSE over N coordinates moves by mean(e * delta) / RMSE plus
    #    mean(delta**2) / RMSE. With the rounding errors independent,
    #    zero-mean and bounded by DELTA (the probabilistic model of rounding
    #    error analysis), Hoeffding bounds the first term by lam * DELTA /
    #    sqrt(N) per coordinate, sqrt(2) times that for the 2-D norm, with
    #    probability 1 - 2 exp(-lam**2 / 2): lam = 6 leaves 3e-8. The second
    #    is below DELTA**2 / RMSE; the fp32 sums of 144 terms add < 144 u
    #    relative, 1e-6 of the RMSE.
    # On the 20 frames, N = 5,760: 5.9e-5 px, 6e-4 of the 0.097 px RMSE
    # (both packages sit ~1e-6 px from the float64 value).
    exact, coords = _reprojection_rmse_f64(infos_t.pose.numpy(), cams[-len(ref.pose):], float(intr.cx), float(intr.cy), 640, 360)
    delta = 2 * 4200 * 2.0**-24
    atol = np.sqrt(2) * 6 * delta / np.sqrt(coords) + delta**2 / exact + 144 * 2.0**-24 * exact
    for name, value in (("port", got), ("reference", want)):
        assert abs(value["reprojection_rmse_px"] - exact) <= atol, (name, value["reprojection_rmse_px"], exact, atol)
    # by default the metric runs on the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.reprojection_rmse(ref.pose, cams[1:], port_intr(intr), 640, 360)


def test_time_fn_needs_the_card_and_profile_trace_writes_a_trace(tmp_path, monkeypatch):
    out = teval.profile_trace(lambda: torch.ones(3) * 2, str(tmp_path / "trace"))
    assert torch.equal(out, torch.full((3,), 2.0))
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.time_fn(lambda: torch.ones(3))
