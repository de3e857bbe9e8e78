"""ptzjax_torch parity on the CPU for the modules that hold kernels:
Harris+NMS detection, the descriptor window gather, and the frontend that
runs both. The JAX side runs its plain jnp paths and, for the Pallas kernels,
interpret mode, as the JAX package's own tests do. The CUDA kernels
themselves are checked against their plain versions in
tests/test_torch_cuda.py, on a GPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import frontend as jfront
from ptzjax.kernels import descriptor as jdesc
from ptzjax.kernels import detect as jdet
from ptzjax.kernels.detect_pallas import harris_nms_pallas
from ptzjax.kernels.window_pallas import gather_windows_pallas
from ptzjax_torch import frontend as tfront
from ptzjax_torch.kernels import descriptor as tdesc
from ptzjax_torch.kernels import detect as tdet
from ptzjax_torch.kernels import harris_nms as thn
from ptzjax_torch.kernels import window_gather as twg
from tests._torch_port import n, port_cfg, render, small_cfg, t, texture
from tests.oracle.harris_np import harris_np, nms3_np

torch.set_num_threads(2)


def _keep(sup) -> np.ndarray:
    return n(sup) > -1e29


class TestHarris:
    def test_response_and_nms_match_reference(self):
        img = texture(h=100, w=200, seed=3)
        resp_j = jdet.harris_response(jnp.asarray(img))
        resp_t = tdet.harris_response(t(img))
        np.testing.assert_allclose(n(resp_t), n(resp_j), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(n(resp_t), harris_np(img), rtol=1e-4, atol=1e-7)
        # keep-sets on the same response map are equal (exact comparisons)
        np.testing.assert_array_equal(_keep(tdet._nms3(resp_t)), _keep(jdet._nms3(jnp.asarray(n(resp_t)))))
        np.testing.assert_array_equal(_keep(tdet._nms3(resp_t)), nms3_np(n(resp_t)) > -1e29)

    def test_cpu_wrapper_is_plain_and_matches_pallas_interior(self):
        img = texture(h=100, w=200, seed=4)
        before = thn.launches
        sup, off, floor = thn.detect_maps(t(img), border=8, threshold=0.01)
        assert thn.launches == before          # a CPU tensor never reaches the kernel
        s_plain, o_plain, f_plain = thn.detect_maps_plain(t(img), border=8, threshold=0.01)
        np.testing.assert_array_equal(n(sup), n(s_plain))
        np.testing.assert_array_equal(n(off), n(o_plain))
        np.testing.assert_array_equal(n(floor), n(f_plain))
        resp_p, sup_p = harris_nms_pallas(jnp.asarray(img))   # interpret mode on the CPU
        b = 8  # the Pallas kernel's edge padding differs within 4 px
        keep = _keep(sup)[b:-b, b:-b]
        np.testing.assert_array_equal(keep, _keep(sup_p)[b:-b, b:-b])
        np.testing.assert_allclose(n(sup)[b:-b, b:-b][keep], n(resp_p)[b:-b, b:-b][keep], rtol=1e-4, atol=1e-7)

    @pytest.mark.parametrize("border", [8, 1])
    @pytest.mark.parametrize("masked", [False, True])
    def test_detect_maps_plain_matches_reference(self, masked, border):
        """sup, off and floor against the JAX package's response, NMS, mask,
        border and subpixel fit (the steps of its detect_keypoints)."""
        img = texture(h=90, w=150, seed=11)
        h, w = img.shape
        mask = None
        if masked:
            mask = np.ones(img.shape, bool)
            mask[:, :40] = False
            mask[30:60, 90:120] = False
        sup, off, floor = thn.detect_maps_plain(
            t(img), None if mask is None else t(mask), border=border, threshold=0.01
        )
        resp_j = jdet.harris_response(jnp.asarray(img))
        sup_j = jdet._nms3(resp_j)
        if mask is not None:
            sup_j = jnp.where(jnp.asarray(mask), sup_j, -1e30)
        yy, xx = np.mgrid[:h, :w]
        inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
        sup_j = jnp.where(jnp.asarray(inb), sup_j, -1e30)
        floor_j = 0.01 * jnp.maximum(sup_j.max(), 1e-20)
        keep = _keep(sup)
        np.testing.assert_array_equal(keep, _keep(sup_j))
        assert keep.sum() > 50 and (not masked or not keep[:, :40].any())
        np.testing.assert_allclose(n(sup)[keep], n(sup_j)[keep], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(n(floor)[0], float(floor_j), rtol=1e-4)
        ys, xs = np.nonzero(keep)
        ox, oy = jdet._subpixel(resp_j, jnp.asarray(ys), jnp.asarray(xs))
        np.testing.assert_allclose(n(off)[keep], np.stack([n(ox), n(oy)], -1), atol=1e-6)
        np.testing.assert_array_equal(n(off)[~keep], 0.0)

    @pytest.mark.parametrize(
        "shape",
        [(720, 1280), (360, 640), (181, 333), (5, 7), (1, 1), (1000, 57), (8, 56), (9, 57), (1080, 1920)],
    )
    def test_plan_covers_every_pixel_once(self, shape):
        """The kernel's grid writes every output pixel exactly once, with
        at most WARPS - 1 idle warps in its last CTA."""
        h, w = shape
        p = thn.plan(h, w)
        assert p.strips * thn.STRIP >= w > (p.strips - 1) * thn.STRIP
        assert p.runs * thn.RUN >= h > (p.runs - 1) * thn.RUN
        assert (p.ctas - 1) * thn.WARPS < p.strips * p.runs <= p.ctas * thn.WARPS
        hits = np.zeros(shape, int)
        for _, rows, cols in thn.warp_tiles(h, w):
            hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        np.testing.assert_array_equal(hits, 1)


def _assert_same_table(got, ref, atol=1e-3):
    """Same valid count, scores in order, and xy equal as sets (tied scores
    may come out in either order)."""
    vg, vr = n(got.valid), n(ref.valid)
    assert vg.sum() == vr.sum() > 0
    k = int(vr.sum())
    np.testing.assert_array_equal(vg[:k], True)
    np.testing.assert_allclose(n(got.score)[:k], n(ref.score)[:k], rtol=1e-4, atol=1e-9)
    xg, xr = n(got.xy)[:k], n(ref.xy)[:k]
    d = np.linalg.norm(xg[:, None, :] - xr[None, :, :], axis=-1)
    assert d.min(1).max() < atol and d.min(0).max() < atol


class TestDetect:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_exact_topk_reference(self, masked):
        img = texture(h=128, w=256, seed=5)
        mask = None
        if masked:
            mask = np.ones(img.shape, bool)
            mask[:, :100] = False
            mask[40:70, 150:200] = False
        ref = jdet.detect_keypoints(
            jnp.asarray(img), 128, threshold=0.01, exact_topk=True,
            mask=None if mask is None else jnp.asarray(mask),
        )
        got = tdet.detect_keypoints(
            t(img), 128, threshold=0.01, mask=None if mask is None else t(mask)
        )
        _assert_same_table(got, ref)
        if masked:
            xy = n(got.xy)[n(got.valid)]
            assert (xy[:, 0] >= 99).all()

    def test_rendered_frame(self):
        imgs, _, _ = render(1, seed=2)
        ref = jdet.detect_keypoints(jnp.asarray(imgs[0]), 160, threshold=0.01, exact_topk=True)
        got = tdet.detect_keypoints(t(imgs[0]), 160, threshold=0.01)
        _assert_same_table(got, ref)


def _desc_inputs():
    img = texture(h=120, w=200, seed=7)
    rng = np.random.default_rng(7)
    xy = np.stack([rng.uniform(1.0, 199.0, 37), rng.uniform(1.0, 119.0, 37)], -1).astype(np.float32)
    xy[0] = [0.2, 0.3]          # extreme corners
    xy[1] = [198.9, 118.7]
    valid = np.ones((37,), bool)
    valid[-2:] = False
    return img, xy, valid


class TestDescriptor:
    @pytest.mark.parametrize("scale", [None, 1.37])
    def test_matches_reference(self, scale):
        img, xy, valid = _desc_inputs()
        ref = jdesc.describe_keypoints(
            jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid),
            scale=None if scale is None else jnp.asarray(scale, jnp.float32),
        )
        got = tdesc.describe_keypoints(
            t(img), t(xy), t(valid),
            scale=None if scale is None else torch.tensor(scale, dtype=torch.float32),
        )
        np.testing.assert_allclose(n(got), n(ref), atol=1e-5)
        np.testing.assert_array_equal(n(got)[-2:], 0.0)

    @pytest.mark.parametrize("win", [tdesc.PATCH + 2, tdesc.SCALED_WIN])
    def test_gather_matches_pallas_bitwise(self, win):
        img, xy, _ = _desc_inputs()
        pimg, ys, xs, _, _ = tdesc._window_starts(t(img), t(xy), win)
        jp, jys, jxs, _, _ = jdesc._window_starts(jnp.asarray(img), jnp.asarray(xy), win)
        np.testing.assert_array_equal(n(pimg), n(jp))
        np.testing.assert_array_equal(n(ys), n(jys))
        np.testing.assert_array_equal(n(xs), n(jxs))
        before = twg.launches
        got = twg.gather_windows(pimg, ys, xs, win)
        assert twg.launches == before          # a CPU tensor never reaches the kernel
        ref = gather_windows_pallas(jp, jys, jxs, win)   # interpret mode on the CPU
        assert got.shape == (xy.shape[0], win + 1, win + 1)
        np.testing.assert_array_equal(n(got), n(ref)[:, : win + 1, : win + 1])


class TestFrontend:
    def test_extract_features_at_live_focal(self):
        imgs, cams, _ = render(1, seed=4)
        cfg = small_cfg(descriptor_f_ref=1100.0)
        focal = np.float32(1137.0)
        xy_j, d_j, v_j = jfront.extract_features(
            jnp.asarray(imgs[0]), cfg, use_pallas=False, focal=jnp.asarray(focal)
        )
        xy_t, d_t, v_t = tfront.extract_features(t(imgs[0]), port_cfg(cfg), focal=torch.tensor(focal))
        np.testing.assert_array_equal(n(v_t), n(v_j))
        np.testing.assert_allclose(n(xy_t), n(xy_j), atol=1e-3)
        np.testing.assert_allclose(n(d_t), n(d_j), atol=1e-5)

    def test_unresolved_auto_focal_warns(self):
        imgs, _, _ = render(1, seed=4)
        with pytest.warns(UserWarning, match="AUTO"):
            tfront.extract_features(t(imgs[0]), port_cfg(small_cfg()), focal=torch.tensor(1100.0))
