"""The port's pyramidal LK (``ptzjax_torch/kernels/flow.py``) against the JAX
package's on the CPU, on tests/test_flow.py's scenes, and that file's
accuracy bars held by the port alone.

Tolerances: pyramid levels within 1e-6 (fp32 blur and pool, sums in
another order); ``tracked`` equal and ``xy`` within 1e-3 px on tracked rows
(the Newton steps' fp32 products are contracted in another order than
XLA's, and the loop amplifies last-bit differences a little)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import synth
from ptzjax.geometry import Intrinsics, back_project_pixels, project_rays
from ptzjax.kernels.detect import detect_keypoints
from ptzjax.kernels.flow import build_pyramid as j_pyramid
from ptzjax.kernels.flow import lk_track as j_lk
from ptzjax_torch.kernels import flow as tflow
from ptzjax_torch.kernels import window_gather as twg
from tests._torch_port import n, t

torch.set_num_threads(2)


def _textured_image(h, w, seed=0):
    return synth.make_panorama(seed=seed).tex[:h, :w].astype(np.float32)


def _translation_pair():
    """tests/test_flow.py's subpixel translation (7.3, -4.6) px, 240x320."""
    pano = synth.make_panorama(seed=3)
    h, w = 240, 320
    y, x = np.mgrid[0:h, 0:w]

    def sample(xs, ys):
        x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
        fx, fy = (xs - x0).astype(np.float32), (ys - y0).astype(np.float32)
        tex = pano.tex
        return (
            tex[y0, x0] * (1 - fy) * (1 - fx) + tex[y0, x0 + 1] * (1 - fy) * fx
            + tex[y0 + 1, x0] * fy * (1 - fx) + tex[y0 + 1, x0 + 1] * fy * fx
        ).astype(np.float32)

    return sample(x + 100.0, y + 100.0), sample(x + 107.3, y + 95.4)


def _render_pair(dpan=0.004, dtilt=-0.002, df=5.0, seed=1):
    """tests/test_flow.py's PTZ step, 640x360."""
    pano = synth.make_panorama(seed=seed)
    intr = Intrinsics.create(320.0, 180.0)
    cam0 = np.array([0.05, -0.05, 1600.0], np.float32)
    cam1 = cam0 + np.array([dpan, dtilt, df], np.float32)
    return synth.render_image(pano, cam0, intr, 640, 360), synth.render_image(pano, cam1, intr, 640, 360), cam0, cam1, intr


def _keypoints(img, k):
    kp = detect_keypoints(jnp.asarray(img), max_keypoints=k, threshold=1e-4, use_pallas=False)
    return np.asarray(kp.xy), np.asarray(kp.valid)


def _both(img0, img1, xy, valid, **kw):
    ref = j_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(xy), jnp.asarray(valid), **kw)
    got = tflow.lk_track(t(img0), t(img1), t(xy), t(valid), **kw)
    return ref, got


def _assert_parity(ref, got):
    np.testing.assert_array_equal(n(got.tracked), n(ref.tracked))
    tr = n(ref.tracked)
    np.testing.assert_allclose(n(got.xy)[tr], n(ref.xy)[tr], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(n(got.xy)[~tr], n(ref.xy)[~tr])   # untracked rows keep their input


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_pyramid_levels_match(levels):
    img = _textured_image(121, 163)               # odd sizes: the crop before the pool
    ref = j_pyramid(jnp.asarray(img), levels)
    got = tflow.build_pyramid(t(img), levels)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(n(g), n(r), atol=1e-6, rtol=0)
    const = tflow.build_pyramid(torch.full((64, 64), 3.5), 3)
    for p in const:
        np.testing.assert_allclose(n(p), 3.5, rtol=1e-6)


def test_translation_matches_and_is_subpixel():
    img0, img1 = _translation_pair()
    xy, valid = _keypoints(img0, 64)
    ref, got = _both(img0, img1, xy, valid)
    _assert_parity(ref, got)
    tracked = n(got.tracked) & valid
    assert tracked.sum() >= 30
    err = np.abs(n(got.xy)[tracked] - xy[tracked] - np.array([-7.3, 4.6]))
    assert np.median(err) < 0.1


def test_ptz_pair_matches_and_follows_the_geometry():
    img0, img1, cam0, cam1, intr = _render_pair()
    xy, valid = _keypoints(img0, 128)
    ref, got = _both(img0, img1, xy, valid)
    _assert_parity(ref, got)
    np.testing.assert_allclose(n(got.residual), n(ref.residual), atol=1e-4)
    gt_xy = np.asarray(project_rays(cam1, back_project_pixels(cam0, jnp.asarray(xy), intr), intr))
    in_view = (gt_xy[:, 0] > 8) & (gt_xy[:, 0] < 632) & (gt_xy[:, 1] > 8) & (gt_xy[:, 1] < 352)
    tracked = n(got.tracked) & valid & in_view
    assert tracked.sum() >= 0.6 * (valid & in_view).sum()
    err = np.linalg.norm(n(got.xy)[tracked] - gt_xy[tracked], axis=-1)
    assert np.median(err) < 0.3 and np.mean(err) < 1.0


def test_out_of_view_points_rejected():
    img0, img1, *_ = _render_pair(dpan=0.012, dtilt=0.0, df=0.0)
    xy = np.array([[3.0, 50.0], [5.0, 200.0], [2.0, 300.0], [320.0, 180.0]], np.float32)
    ref, got = _both(img0, img1, xy, np.ones(4, bool))
    _assert_parity(ref, got)
    ok = n(got.tracked)
    assert ok[3] and not ok[:3].any()
    assert abs(float(n(got.xy)[3, 0]) - 320.0 + 0.012 * 1600.0) < 0.5


def test_invalid_rows_and_flat_region():
    img = _textured_image(120, 160)
    xy = np.array([[40.0, 40.0], [80.0, 60.0]], np.float32)
    ref, got = _both(img, img, xy, np.array([True, False]))
    _assert_parity(ref, got)
    assert n(got.tracked).tolist() == [True, False]
    np.testing.assert_allclose(n(got.xy)[0], xy[0], atol=1e-3)

    flat = np.zeros((96, 128), np.float32)
    ref, got = _both(flat, flat, np.array([[64.0, 48.0]], np.float32), np.array([True]))
    _assert_parity(ref, got)
    assert not bool(got.tracked[0])


def test_non_finite_positions_do_not_crash_and_are_not_tracked():
    """A NaN or infinite position reaches the integer casts and the clamped
    gathers; it comes back untracked, and the finite rows are unaffected."""
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 16)
    bad = xy.copy()
    bad[:3] = [[np.nan, 40.0], [np.inf, -np.inf], [1e9, -1e9]]
    got = tflow.lk_track(t(img0), t(img1), t(bad), t(valid))
    clean = tflow.lk_track(t(img0), t(img1), t(xy), t(valid))
    assert not n(got.tracked)[:3].any()
    np.testing.assert_array_equal(n(got.tracked)[3:], n(clean.tracked)[3:])
    np.testing.assert_array_equal(n(got.xy)[3:], n(clean.xy)[3:])


def test_fb_check_off_and_levels_options_match():
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 96)
    for kw in (dict(fb_check=False), dict(levels=2, iters=5, patch=9)):
        ref, got = _both(img0, img1, xy, valid, **kw)
        _assert_parity(ref, got)


def test_cpu_tensors_take_the_plain_gather():
    """On the CPU every window goes through the plain gather: no kernel
    launch is counted, and the result lies on the CPU."""
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 32)
    before = twg.launches
    got = tflow.lk_track(t(img0), t(img1), t(xy), t(valid))
    assert twg.launches == before
    assert got.xy.device.type == "cpu" and got.tracked.dtype == torch.bool


def test_numpy_inputs_run_on_the_card_by_default(monkeypatch):
    """numpy inputs with no device go to the card; without CUDA that raises
    rather than falling back to the CPU. ``device="cpu"`` asks for the CPU."""
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflow.lk_track(img0, img1, xy, valid)
    got = tflow.lk_track(img0, img1, xy, valid, device="cpu")
    ref = tflow.lk_track(t(img0), t(img1), t(xy), t(valid))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# --- kernel E's route (csrc/lk_flow.cu): what the CPU can check -------------


def test_cpu_tensors_launch_no_lk_kernel():
    """On the CPU ``lk_track`` takes the plain route: no launch of kernel E
    (nor of B) is counted, and the wrapper on prebuilt pyramids is the plain
    version bit for bit."""
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 32)
    e0, b0 = tflow.launches, twg.launches
    got = tflow.lk_track(t(img0), t(img1), t(xy), t(valid))
    assert tflow.launches == e0 and twg.launches == b0
    pyr0, pyr1 = tflow.build_pyramid(t(img0), 4), tflow.build_pyramid(t(img1), 4)
    opts = dict(patch=13, iters=8, min_eig=1e-3, max_residual=0.5, fb_check=True, fb_tol=1.0, border=2.0)
    wrapped = tflow.lk_pyramids(pyr0, pyr1, t(xy), t(valid), **opts)
    plain = tflow.lk_pyramids_plain(pyr0, pyr1, t(xy), t(valid), **opts)
    assert tflow.launches == e0
    for a, b, c in zip(got, wrapped, plain):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_a_device_that_is_neither_cpu_nor_cuda_raises():
    img0, img1, *_ = _render_pair()
    xy, valid = _keypoints(img0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tflow.lk_track(img0, img1, xy, valid, device="meta")
    meta = [torch.empty((90, 160), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        tflow.lk_pyramids(
            meta, meta, torch.empty((8, 2), device="meta"), torch.empty(8, dtype=torch.bool, device="meta"),
            patch=13, iters=8, min_eig=1e-3, max_residual=0.5, fb_check=True, fb_tol=1.0, border=2.0,
        )


@pytest.mark.parametrize(
    "levels, patch, h, w",
    [(4, 17, 720, 1280), (4, 12, 720, 1280), (4, 0, 720, 1280), (0, 13, 720, 1280), (9, 13, 720, 1280), (4, 13, 4, 1280)],
)
def test_plan_refuses_what_the_kernel_does_not_take(levels, patch, h, w):
    """A patch above MAX_PATCH or even, levels outside 1..MAX_LEVELS or a
    pyramid with an empty top level raise before any launch (the card's
    route calls ``plan`` first; nothing falls back to the plain route)."""
    before = tflow.launches
    with pytest.raises(ValueError, match="lk_track"):
        tflow.plan(512, levels, patch, h, w)
    assert tflow.launches == before


def test_plan_gives_a_warp_a_keypoint():
    """Kernel E's LK launch gives a keypoint a CTA of ``WARPS_PER_CTA``
    warps (the name is the first layout's, a warp a keypoint): 512
    keypoints are 512 CTAs of 4 warps, whose 128 threads hold the patch's
    169 samples (at most 225) two a thread at most."""
    assert tflow.WARPS_PER_CTA == 4 and 2 * 32 * tflow.WARPS_PER_CTA >= tflow.MAX_PATCH**2
    assert tflow.plan(512, 4, 13, 720, 1280) == 512
    assert tflow.plan(513, 4, 13, 720, 1280) == 513
    assert tflow.plan(0, 1, tflow.MAX_PATCH, 1, 1) == 0
    assert tflow.plan(160, tflow.MAX_LEVELS, 1, 720, 1280) == 160


@pytest.mark.parametrize(
    "h, w, levels, want",
    [
        (720, 1280, 4, [(1, 3)]),                  # the bench pair: one launch
        (720, 1280, 1, []),                        # no level to build
        (720, 1280, 8, [(1, 3), (4, 3), (7, 1)]),
        (121, 163, 3, [(1, 2)]),
        (8, 8, 4, [(1, 3)]),                       # a top level of 1 px
    ],
)
def test_pyramid_plan_builds_three_levels_a_launch(h, w, levels, want):
    """The pyramid launches: levels 1..levels-1, three a launch."""
    assert tflow.pyramid_plan(h, w, levels) == want


@pytest.mark.parametrize("levels, h, w", [(0, 720, 1280), (9, 720, 1280), (4, 7, 1280), (4, 720, 4)])
def test_pyramid_plan_refuses_an_empty_level(levels, h, w):
    with pytest.raises(ValueError, match="build_pyramid"):
        tflow.pyramid_plan(h, w, levels)


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_plain_pyramid_and_the_cpu_route_match_the_reference(levels):
    """``build_pyramid_plain`` (the pyramid launch's specification) against
    ``ptzjax``'s pyramid at ``test_pyramid_levels_match``'s levels and
    sizes, within its 1e-6; on the CPU ``build_pyramids`` of two frames is
    the plain version bit for bit and launches nothing."""
    img = _textured_image(121, 163)
    other = _textured_image(121, 163, seed=2)
    ref = j_pyramid(jnp.asarray(img), levels)
    plain = tflow.build_pyramid_plain(t(img), levels)
    assert [tuple(g.shape) for g in plain] == [r.shape for r in ref]
    for r, g in zip(ref, plain):
        np.testing.assert_allclose(n(g), n(r), atol=1e-6, rtol=0)
    before = tflow.pyramid_launches
    both = tflow.build_pyramids([t(img), t(other)], levels)
    assert tflow.pyramid_launches == before
    for got, want in zip(both, (plain, tflow.build_pyramid_plain(t(other), levels))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _cta_sum(x: torch.Tensor) -> torch.Tensor:
    """Kernel E's sum over a patch (csrc/lk_flow.cu:cta_sum) in torch, for
    (K, S) per-sample values, S <= 256: sample s to thread s mod 128, a
    thread's two in order, each warp's xor butterfly, then the four warps'
    sums in order."""
    k, s = x.shape
    threads = 32 * tflow.WARPS_PER_CTA
    dealt = torch.zeros((k, 2 * threads), dtype=x.dtype)
    dealt[:, :s] = x
    lanes = ((0.0 + dealt[:, :threads]) + dealt[:, threads:]).reshape(k, tflow.WARPS_PER_CTA, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    total = lanes[:, 0, 0]
    for wi in range(1, tflow.WARPS_PER_CTA):
        total = total + lanes[:, wi, 0]
    return total


def _kernel_order_level(prev, nxt, xy_prev, guess, patch: int, iters: int):
    """``flow._lk_level`` as kernel E orders it: the same template and
    gradients, every sum over the patch ``_cta_sum``, G's sums and the
    template's mean together, the std in two passes, the sample its 4-tap
    form (``_tap_sample``)."""
    k, num = xy_prev.shape[0], patch * patch
    tmpl_w = tflow._sample_patches(prev, xy_prev, patch + 2)
    tmpl = tmpl_w[:, 1:-1, 1:-1].reshape(k, num)
    gx = (0.5 * (tmpl_w[:, 1:-1, 2:] - tmpl_w[:, 1:-1, :-2])).reshape(k, num)
    gy = (0.5 * (tmpl_w[:, 2:, 1:-1] - tmpl_w[:, :-2, 1:-1])).reshape(k, num)
    gxx, gxy, gyy, st = (_cta_sum(v) for v in (gx * gx, gx * gy, gy * gy, tmpl))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig = (0.5 * (tr - torch.sqrt((tr * tr - 4.0 * det).clamp_min(0.0)))) / num
    inv_det = torch.where(det > 1e-12, 1.0 / det.clamp_min(1e-12), 0.0)
    mean = st / num
    win = patch + 2 * tflow._DISP + 1
    windows, anchor = tflow._extract_windows(nxt, guess, win, tflow._DISP + patch // 2)

    def sample(g):
        return _tap_sample(windows, g - anchor - (patch - 1) / 2.0, patch).reshape(k, num)

    for _ in range(iters):
        di = tmpl - sample(guess)
        bx, by = _cta_sum(di * gx), _cta_sum(di * gy)
        guess = guess + torch.stack([inv_det * (gyy * bx - gxy * by), inv_det * (gxx * by - gxy * bx)], -1)
    sa = _cta_sum((tmpl - sample(guess)).abs())
    sv = _cta_sum((tmpl - mean[:, None]) * (tmpl - mean[:, None]))
    resid = (sa / num) / torch.sqrt(sv / num).clamp_min(1e-6)
    return guess, eig, resid


@pytest.mark.parametrize("pair", ["translation", "ptz"])
def test_kernel_sum_order_lands_within_the_plain_tolerance(pair, monkeypatch):
    """Kernel E's order of every sum over the patch (``_cta_sum``: a
    thread's samples, the warp butterfly, the warps in order) and its 4-tap
    sample, modelled in torch through the plain route's levels, forward and
    backward: ``tracked`` equal to the plain route's and ``xy`` within its
    1e-3 px on tracked rows. A CTA of ones sums to the count exactly."""
    assert torch.equal(_cta_sum(torch.ones((1, 169))), torch.tensor([169.0]))
    img0, img1 = _translation_pair() if pair == "translation" else _render_pair()[:2]
    xy, valid = _keypoints(img0, 96)
    pyr0, pyr1 = tflow.build_pyramid(t(img0), 4), tflow.build_pyramid(t(img1), 4)
    opts = dict(patch=13, iters=8, min_eig=1e-3, max_residual=0.5, fb_check=True, fb_tol=1.0, border=2.0)
    plain = tflow.lk_pyramids_plain(pyr0, pyr1, t(xy), t(valid), **opts)
    monkeypatch.setattr(tflow, "_lk_level", _kernel_order_level)
    model = tflow.lk_pyramids_plain(pyr0, pyr1, t(xy), t(valid), **opts)
    tracked = plain.tracked
    assert int(tracked.sum()) >= 30
    assert torch.equal(model.tracked, tracked)
    torch.testing.assert_close(model.xy[tracked], plain.xy[tracked], rtol=0, atol=1e-3)
    torch.testing.assert_close(model.residual[tracked], plain.residual[tracked], rtol=0, atol=1e-4)


def _tap_sample(windows: torch.Tensor, corner: torch.Tensor, patch: int) -> torch.Tensor:
    """Kernel E's sample (csrc/lk_flow.cu:window_sample) in torch: at patch
    sample (p, q), the 4 taps around t = clamp(corner + (q, p), 0, W - 1)
    with weights clamp(1 - |t - j|, 0, 1), along y first and then x."""
    k, win, _ = windows.shape
    p = torch.arange(patch, dtype=torch.float32)
    ty = (corner[:, 1:2] + p).clamp(0.0, win - 1.0)                 # (K, P)
    tx = (corner[:, 0:1] + p).clamp(0.0, win - 1.0)
    i0, j0 = ty.long().clamp(max=win - 2), tx.long().clamp(max=win - 2)

    def weight(tt, j):
        return (1.0 - (tt - j.to(torch.float32)).abs()).clamp(0.0, 1.0)

    wy0, wy1, wx0, wx1 = weight(ty, i0), weight(ty, i0 + 1), weight(tx, j0), weight(tx, j0 + 1)
    kk = torch.arange(k)[:, None, None]

    def tap(di, dj):
        return windows[kk, (i0 + di)[:, :, None], (j0 + dj)[:, None, :]]

    a0 = wy0[:, :, None] * tap(0, 0) + wy1[:, :, None] * tap(1, 0)    # along y, column j0
    a1 = wy0[:, :, None] * tap(0, 1) + wy1[:, :, None] * tap(1, 1)    # column j0 + 1
    return wx0[:, None, :] * a0 + wx1[:, None, :] * a1


def test_tap_sample_equals_the_selection_matrix_product():
    """The plain version's sample, ``sy @ window @ sx^T`` with bilinear
    selection matrices, is the 4-tap bilinear sample that kernel E computes,
    also where t is clamped (t < 0, t = W - 1, t > W - 1). Tolerance: each
    of the two passes sums the same two nonzero products, rounded in
    another order (the product has zeros and may contract to an FMA), so
    they differ by at most 2 ulp of the window's largest value a pass:
    4 * 2**-23 for values in [0, 1)."""
    patch, win = 13, 13 + 2 * tflow._DISP + 1
    rng = np.random.default_rng(5)
    windows = t(rng.uniform(0.0, 1.0, (64, win, win)).astype(np.float32))
    corner = rng.uniform(-3.0, win - patch + 3.0, (64, 2)).astype(np.float32)
    corner[:6] = [
        [-1.5, -0.25],                                   # t < 0 for the first rows and columns
        [win - patch, win - patch],                      # the last sample at t = W - 1 exactly
        [win - patch + 2.5, win - patch + 0.75],         # t > W - 1
        [0.0, 0.0], [-20.0, 40.0], [3.5, 4.0],           # integral corners, far off both sides
    ]
    corner_t = t(corner)
    sy = tflow._sel_weights(corner_t[:, 1], patch, win)
    sx = tflow._sel_weights(corner_t[:, 0], patch, win)
    want = torch.bmm(torch.bmm(sy, windows), sx.transpose(1, 2))
    got = _tap_sample(windows, corner_t, patch)
    torch.testing.assert_close(got, want, rtol=0, atol=4 * 2.0**-23)
