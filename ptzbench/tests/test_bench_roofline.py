"""``roofline.py``'s counts against counts made by hand at small shapes."""

from __future__ import annotations

import pytest
import torch

from ptzbench import roofline
from ptzbench.reference.kernels import descriptor as kd


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 67e12) == pytest.approx(1.0)
    assert roofline.share_pct([(3.35e6, 0.0)] * 2, 4e-6) == pytest.approx(50.0)
    assert roofline.share_pct([], 1.0) is None and roofline.share_pct([(1.0, 1.0)], 0.0) is None


def test_harris_nms_counts():
    # a 4 x 5 frame: 20 pixels read and 20 written, 4 B each, and the floor
    assert roofline.harris_nms_work(4, 5) == (8 * 20 + 4, 78 * 20)
    assert roofline.harris_nms_work(4, 5, masked=True) == (8 * 20 + 20 + 4, 78 * 20)


def test_match_counts():
    # 3 x 2 rows of 4 floats: 2 * 3 * 2 * 4 products and sums
    b, o = roofline.match_work(3, 2, 4, gated=False, mutual=False)
    assert o == 48
    assert b == 4 * 5 * 4 + 5 + 12 * 3
    b2, _ = roofline.match_work(3, 2, 4, gated=True, mutual=True)
    assert b2 == b + 8 * 5 + 4 * 2


def test_cholesky_counts():
    # n = 3: 6 entries of the lower triangle read, 9 of the factor written
    assert roofline.cholesky_work(3) == (4 * (6 + 9) + 4, 9.0)


def test_pyramid_counts():
    # an 8 x 8 frame, 2 levels: 64 read, 16 written; 9 x 2 x 4 x 8 vertical,
    # 9 x 4 x 4 x 4 horizontal and 4 x 16 pool operations
    assert roofline.pyramid_work(8, 8, 2, 1) == (4 * (64 + 16), 9 * 2 * 4 * 8 + 9 * 4 * 16 + 4 * 16)
    assert roofline.pyramid_work(8, 8, 2, 2) == (2 * 4 * 80, 2 * (576 + 576 + 64))


def test_describe_counts_one_interior_keypoint_without_scale():
    # no scale: the aligned 18 x 18 grid, its 4 corner samples unused, each
    # sample blending a 2 x 2 window: a 19 x 19 block of pixels less its 4
    # corners
    img = torch.zeros(64, 64)
    xy = torch.tensor([[32.0, 32.0]])
    valid = torch.tensor([True])
    b, o = roofline.describe_work(img, xy, valid, None)
    assert b == 4 * (19 * 19 - 4) + 1 * (9 + 4 * 128)
    nonzero = int((kd._spatial_weights() != 0).sum())
    assert o == 11 * (18 * 18 - 4) + 16 * 256 + 6 * nonzero + 4 * 256 + 10 * 128


def test_describe_counts_shared_pixels_once():
    img = torch.zeros(64, 64)
    one = roofline.describe_work(img, torch.tensor([[32.0, 32.0]]), torch.tensor([True]), None)
    two = roofline.describe_work(img, torch.tensor([[32.0, 32.0], [33.0, 32.0]]), torch.tensor([True, True]), None)
    # the second window moves one column: 19 new pixels (its corners' changes
    # cancel: 2 corners become interior, 2 new corners are unused)
    assert two[0] - one[0] == 4 * 19 + (9 + 4 * 128)
    assert two[1] == 2 * one[1]


def test_lk_counts_grow_with_the_keypoints():
    from ptzbench.reference.kernels.flow import build_pyramid_plain

    g = torch.Generator().manual_seed(0)
    img = torch.rand(96, 128, generator=g)
    pyr = build_pyramid_plain(img, 2)
    opts = dict(patch=5, iters=2, min_eig=1e-3, max_residual=0.5, fb_check=False, border=2.0)
    xy1 = torch.tensor([[60.0, 40.0]])
    b1, o1 = roofline.lk_work(pyr, pyr, xy1, torch.tensor([True]), **opts)
    # one keypoint, two levels of one pass each: (patch + 2)^2 x 11 +
    # patch^2 x 14 a pass, then 12 a sample and Newton step (3 coarse
    # steps, 2 fine) and 10 a sample for the residual of each level
    assert o1 == 2 * (7 * 7 * 11 + 25 * 14) + 25 * (12 * 5 + 10 * 2)
    b2, o2 = roofline.lk_work(pyr, pyr, torch.cat([xy1, xy1 + 40]), torch.tensor([True, True]), **opts)
    assert o2 == 2 * o1 and b2 > b1
