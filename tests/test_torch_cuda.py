"""The port's CUDA kernels and its main path on an NVIDIA GPU, against the
plain torch versions of the same code. Every test needs a card and skips
without one.

This file imports no jax (the GPU machine has none), so it can run there on
its own, without tests/conftest.py (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import functools

import numpy as np
import pytest
import torch

from ptzjax_torch import checkpoint as tckpt
from ptzjax_torch import synth
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics
from ptzjax_torch.kernels import cholesky as tch
from ptzjax_torch.kernels import descriptor as tdesc
from ptzjax_torch.kernels import flow as tflow
from ptzjax_torch.kernels import harris_nms as thn
from ptzjax_torch.kernels import match as tkm
from ptzjax_torch.kernels import window_gather as twg
from ptzjax_torch.kernels.detect import detect_keypoints
from ptzjax_torch.slam import PTZSlam

pytestmark = pytest.mark.cuda

W, H = 640, 360


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _render(num_frames, seed=1):
    """tests/test_frontend.py's 640x360 sweep, rendered by the port."""
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=seed
    )
    cams = synth.make_trajectory(
        num_frames, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=1100.0, f_amp=60.0,
        period=num_frames * 1.6, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    return np.stack([synth.render_image(pano, c, intr, W, H) for c in cams]), cams, intr


def _maps_equal(got, ref):
    """sup and floor bitwise, off bitwise at the survivors (elsewhere the
    kernel leaves it unspecified)."""
    (sup, off, floor), (p_sup, p_off, p_floor) = got, ref
    keep = p_sup > -1e29
    return torch.equal(sup, p_sup) and torch.equal(floor, p_floor) and torch.equal(off[keep], p_off[keep])


def _boxes(shape, device):
    """A mask with two rectangular boxes cut out (True where allowed)."""
    h, w = shape
    m = torch.ones(shape, dtype=torch.bool, device=device)
    m[h // 5: h // 2, w // 6: w // 3] = False
    m[2 * h // 3:, w // 2: 3 * w // 4] = False
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(360, 640), (181, 333), (5, 7), (1, 1)])
def test_harris_nms_matches_plain_everywhere(cuda_device, shape, masked):
    """Strip and run edges, odd widths, images smaller than a strip and a
    single pixel: the kernel is bitwise its plain version over the whole
    image, at border 8 and 1."""
    img = torch.from_numpy(
        np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    ).to(cuda_device)
    mask = _boxes(shape, cuda_device) if masked else None
    for border in (8, 1):
        before = thn.launches
        got = thn.detect_maps(img, mask, border, 0.01)
        assert thn.launches == before + 1
        assert _maps_equal(got, thn.detect_maps_plain(img, mask, border, 0.01))


def test_detect_keypoints_on_card_matches_plain(cuda_device):
    """The whole detection call, the kernel path on the card against the
    plain path (the CPU tensor), with and without a mask."""
    imgs, _, _ = _render(1)
    img = torch.from_numpy(imgs[0]).to(cuda_device)
    for mask in (None, _boxes(img.shape, cuda_device)):
        got = detect_keypoints(img, 512, threshold=1e-4, mask=mask)
        ref = detect_keypoints(img.cpu(), 512, threshold=1e-4, mask=None if mask is None else mask.cpu())
        assert int(ref.valid.sum()) > 100
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)


def test_detect_maps_repeatable_across_shapes(cuda_device):
    """Three calls at alternating shapes are bitwise equal call for call: the
    ticket counter the last CTA resets leaves no state behind, also when
    the next call's grid differs."""
    rng = np.random.default_rng(3)
    calls = [
        (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device), m)
        for s, m in (((360, 640), False), ((181, 333), True), ((720, 1280), False))
    ]
    calls = [(img, _boxes(img.shape, cuda_device) if m else None) for img, m in calls]
    outs = [[thn.detect_maps(img, mask, 8, 0.01) for img, mask in calls] for _ in range(3)]
    for later in outs[1:]:
        for x, y in zip(outs[0], later):
            assert _maps_equal(x, y)


@pytest.mark.parametrize("win", [tdesc.PATCH + 2, tdesc.SCALED_WIN])
def test_gather_windows_bitwise(cuda_device, win):
    imgs, _, _ = _render(1)
    rng = np.random.default_rng(win)
    xy = rng.uniform([0, 0], [W - 1, H - 1], (512, 2)).astype(np.float32)
    xy[:2] = [[0.2, 0.3], [W - 1.1, H - 1.3]]                   # extreme corners
    img = torch.from_numpy(imgs[0]).to(cuda_device)
    pimg, ys, xs, _, _ = tdesc._window_starts(img, torch.from_numpy(xy).to(cuda_device), win)
    before = twg.launches
    got = twg.gather_windows(pimg, ys, xs, win)
    assert twg.launches == before + 1
    assert torch.equal(got, twg.gather_windows_plain(pimg, ys, xs, win))
    # out-of-range starts are clamped, as in the plain version
    far = torch.full_like(ys, 10**6)
    assert torch.equal(
        twg.gather_windows(pimg, far, -far, win), twg.gather_windows_plain(pimg, far, -far, win)
    )


@pytest.mark.parametrize("side", [16, 24])
def test_gather_windows_lk_sides_bitwise(cuda_device, side):
    """The LK template (side 16) and search (side 24) windows at level 0 and
    at a coarse level, through ``flow._gather`` as LK calls it, with starts
    past both edges."""
    imgs, _, _ = _render(1)
    level0 = torch.from_numpy(imgs[0]).to(cuda_device)
    for img in (level0, tflow.build_pyramid(level0, 4)[3]):
        pimg = tflow._edge_pad(img, side)
        hp, wp = pimg.shape
        rng = np.random.default_rng(side)
        ys = torch.from_numpy(rng.integers(-5, hp - side + 5, 512).astype(np.int32)).to(cuda_device)
        xs = torch.from_numpy(rng.integers(-5, wp - side + 5, 512).astype(np.int32)).to(cuda_device)
        before = twg.launches
        got = tflow._gather(pimg, ys, xs, side)
        assert twg.launches == before + 1 and got.shape == (512, side, side)
        assert torch.equal(got, twg.gather_windows_plain(pimg, ys, xs, side - 1))


def _frame_720p(device):
    """One 1280 x 720 view of the ``_render`` panorama and its 512 Harris
    keypoints at the SLAMConfig defaults."""
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=1
    )
    intr = Intrinsics.create(640.0, 360.0)
    frame = synth.render_image(pano, np.array([0.02, -0.05, 2000.0], np.float32), intr, 1280, 720)
    img = torch.from_numpy(np.asarray(frame, np.float32)).to(device)
    kp = detect_keypoints(img, 512, threshold=SLAMConfig().detector_threshold)
    assert int(kp.valid.sum()) > 400
    return img, kp.xy, kp.valid


def _f_and_plain(img, xy, valid, scale):
    """Kernel F (one launch, no window gather) and the plain route on the
    card (one gather, no F) on the same inputs."""
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32, device=img.device)
    f0, b0 = tdesc.launches, twg.launches
    got = tdesc.describe_keypoints(img, xy, valid, scale=s)
    assert tdesc.launches == f0 + 1 and twg.launches == b0
    ref = tdesc.describe_keypoints(img, xy, valid, scale=s, plain=True)
    assert tdesc.launches == f0 + 1 and twg.launches == b0 + 1
    return got, ref


@pytest.mark.parametrize("scale", [None, 0.4, 1.0, 1.37, 2.5])
def test_descriptor_kernel_matches_the_plain_route(cuda_device, scale):
    """F against ``describe_keypoints(..., plain=True)`` at 512 keypoints on a
    720p frame: within 1e-5 per component, zeros on invalid rows; three
    calls bitwise equal."""
    img, xy, valid = _frame_720p(cuda_device)
    valid = valid.clone()
    valid[-8:] = False
    got, ref = _f_and_plain(img, xy, valid, scale)
    assert got.shape == (512, tdesc.DESC_DIM) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert not bool(got[~valid].any())
    norms = torch.linalg.vector_norm(got[valid], dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-5)
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    for _ in range(2):
        assert torch.equal(tdesc.describe_keypoints(img, xy, valid, scale=s), got)


def test_descriptor_kernel_at_other_table_sizes(cuda_device):
    """K = 37 (a partial wave) and K = 0 (no launch, an empty result)."""
    img, xy, valid = _frame_720p(cuda_device)
    for scale in (None, 1.37):
        got, ref = _f_and_plain(img, xy[:37].contiguous(), valid[:37].contiguous(), scale)
        assert got.shape == (37, tdesc.DESC_DIM)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    f0 = tdesc.launches
    empty = tdesc.describe_keypoints(img, xy[:0], valid[:0])
    assert empty.shape == (0, tdesc.DESC_DIM) and tdesc.launches == f0


@pytest.mark.parametrize("scale", [None, 0.4, 1.37, 2.5])
def test_descriptor_kernel_edge_far_and_non_finite_rows(cuda_device, scale):
    """Rows at the corners and edges, far off the image (past the int32
    range too, where the conversion saturates and the start wraps as
    torch's int32 does), invalid rows (one NaN) and valid non-finite rows:
    F gives what the plain route gives on the card. A valid NaN row is all
    NaN there; a valid infinite row is a finite descriptor at an edge."""
    img, xy, valid = _frame_720p(cuda_device)
    xy, valid = xy[:32].clone(), valid[:32].clone()
    h, w = img.shape
    xy[:14] = torch.tensor(
        [[0.2, 0.3], [w - 1.1, h - 1.3], [0.0, h - 0.6], [w - 0.6, 0.0], [3.0, h / 2], [w / 2, h - 2.0],
         [1e9, -1e9], [-1e9, 1e9], [3e9, -3e9], [-5e9, 5e9], [np.nan, 40.0], [np.inf, -np.inf],
         [np.nan, np.nan], [w / 2, h / 2]],
        device=cuda_device,
    )
    valid[:13] = True
    valid[12:14] = False
    got, ref = _f_and_plain(img, xy, valid, scale)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5, equal_nan=True)
    assert not bool(got[12:14].any())
    assert bool(torch.isnan(got[10]).all()) and bool(torch.isfinite(got[11]).all())
    assert bool(torch.isfinite(got[:10]).all())


@pytest.mark.parametrize("scale", [0.1, 0.4, 2.5, 10.0, None])
def test_descriptor_kernel_at_the_clamp_ends_with_a_non_finite_patch(cuda_device, scale):
    """F at both clamp ends of the scale (and past them) and without one, on
    a frame with an infinite pixel at one keypoint and a NaN pixel at
    another: those rows all NaN on both routes, every row where the plain
    route is finite F's within 1e-5, and a row NaN through F only where the
    plain route's is (F reads only the pixels its taps reach; the plain
    route's dense product also reads the rest of the window, 0 x inf)."""
    img, xy, valid = _frame_720p(cuda_device)
    bad = img.clone()
    rows = valid.nonzero().flatten()[[3, 40]].tolist()
    for row, value in zip(rows, (float("inf"), float("nan"))):
        bad[int(xy[row, 1]), int(xy[row, 0])] = value
    got, ref = _f_and_plain(bad, xy, valid, scale)
    assert bool(torch.isnan(got[rows]).all() and torch.isnan(ref[rows]).all())
    finite = torch.isfinite(ref).all(1)
    assert int(finite.sum()) > 400
    torch.testing.assert_close(got[finite], ref[finite], rtol=0, atol=1e-5)
    got_nan = torch.isnan(got).any(1)
    assert bool((got_nan <= ~finite).all()) and bool((torch.isnan(got[got_nan]).all()))
    if scale is None:
        assert torch.equal(got_nan, ~finite)
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    again = tdesc.describe_keypoints(bad, xy, valid, scale=s)
    assert torch.equal(again.nan_to_num(7.0), got.nan_to_num(7.0))


def test_descriptor_kernel_refuses_what_it_does_not_take(cuda_device):
    """A wrong dtype, a wrong device or a non-contiguous input raises before
    any launch; nothing falls back to the plain route."""
    img, xy, valid = _frame_720p(cuda_device)
    s = torch.tensor(1.0, device=cuda_device)
    f0, b0 = tdesc.launches, twg.launches
    bad = (
        (img.double(), xy, valid, s), (img, xy.double(), valid, s), (img, xy, valid.to(torch.uint8), s),
        (img, xy, valid, s.double()), (img, xy.cpu(), valid, s), (img, xy, valid.cpu(), s),
        (img, xy, valid, s.cpu()), (img.cpu(), xy, valid, s), (img.T, xy, valid, s),
        (img, xy.T.contiguous().T, valid, s), (img, xy, valid, torch.ones(2, device=cuda_device)),
        (img, xy[:, 0], valid, s), (img[None], xy, valid, s),
    )
    for args in bad:
        with pytest.raises(ValueError, match="describe_keypoints"):
            tdesc.describe_kernel(*args)
    with pytest.raises(ValueError, match="describe_keypoints"):
        tdesc.describe_keypoints(img, xy.cpu(), valid)   # a CPU table for a card image
    assert tdesc.launches == f0 and twg.launches == b0


def _lk_pair(device):
    imgs, _, _ = _render(30)
    frames = torch.from_numpy(imgs[:2]).to(device)
    kp = detect_keypoints(frames[0], 160, threshold=1e-4)
    return frames[0], frames[1], kp.xy, kp.valid


def test_lk_track_on_card_matches_cpu(cuda_device):
    """The card (kernel E, a pyramid launch and an LK launch a call at 4
    levels with the backward check, no window gather) against the CPU
    (plain route): ``tracked`` equal, ``xy`` within 1e-3 px on tracked
    rows."""
    e0, b0, p0 = tflow.launches, twg.launches, tflow.pyramid_launches
    got = tflow.lk_track(*_lk_pair(cuda_device))
    assert tflow.launches == e0 + 1 and twg.launches == b0 and tflow.pyramid_launches == p0 + 1
    ref = tflow.lk_track(*_lk_pair("cpu"))
    tracked = ref.tracked
    assert int(tracked.sum()) > 100
    assert torch.equal(got.tracked.cpu(), tracked)
    torch.testing.assert_close(got.xy.cpu()[tracked], ref.xy[tracked], rtol=0, atol=1e-3)


def _with_edge_rows(xy, valid, w, h):
    """The table with rows at the four edges and corners, an invalid row and
    non-finite and far-off positions."""
    xy, valid = xy.clone(), valid.clone()
    xy[:9] = torch.tensor(
        [[0.3, 0.2], [w - 1.4, h - 0.6], [5.0, h - 10.0], [w - 3.0, 4.0], [2.5, h / 2],
         [np.nan, 40.0], [np.inf, -np.inf], [1e9, -1e9], [w / 2, h / 2]],
        device=xy.device,
    )
    valid[8] = False
    return xy, valid


def _kernel_e_parity(got, ref, xy, valid):
    """Kernel E against the plain route on the card: ``tracked`` equal, ``xy``
    within 1e-3 px and the residual within 1e-4 on tracked rows (the plain
    route's bmm sums in another order), the input position elsewhere."""
    tracked = ref.tracked
    assert torch.equal(got.tracked, tracked)
    assert not bool(tracked[5:9].any()) and not bool((tracked & ~valid).any())
    torch.testing.assert_close(got.xy[tracked], ref.xy[tracked], rtol=0, atol=1e-3)
    torch.testing.assert_close(got.residual[tracked], ref.residual[tracked], rtol=0, atol=1e-4)
    torch.testing.assert_close(got.xy[~tracked], xy[~tracked], rtol=0, atol=0, equal_nan=True)


def _small_step_pair(device):
    """Two 640x360 views of the ``_render`` panorama a step of (0.003,
    -0.002, 4) apart, ~3 px of motion: within one level's reach."""
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=1
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    cam0 = np.array([0.02, -0.05, 1100.0], np.float32)
    frames = [synth.render_image(pano, c, intr, W, H) for c in (cam0, cam0 + np.array([0.003, -0.002, 4.0], np.float32))]
    img0, img1 = (torch.from_numpy(np.asarray(f, np.float32)).to(device) for f in frames)
    kp = detect_keypoints(img0, 160, threshold=1e-4)
    return img0, img1, kp.xy, kp.valid


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_lk_kernel_matches_the_plain_route(cuda_device, levels):
    """Kernel E (an LK launch, a pyramid launch where there is a level to
    build, no gather) against ``lk_track(..., plain=True)`` on the same card
    tensors, with and without the backward check, rows at the edges, an
    invalid row and non-finite rows included."""
    img0, img1, xy, valid = _small_step_pair(cuda_device)
    xy, valid = _with_edge_rows(xy, valid, W, H)
    for fb_check in (True, False):
        e0, b0, p0 = tflow.launches, twg.launches, tflow.pyramid_launches
        got = tflow.lk_track(img0, img1, xy, valid, levels=levels, fb_check=fb_check)
        assert tflow.launches == e0 + 1 and twg.launches == b0 and tflow.pyramid_launches == p0 + (levels > 1)
        ref = tflow.lk_track(img0, img1, xy, valid, levels=levels, fb_check=fb_check, plain=True)
        assert tflow.launches == e0 + 1 and tflow.pyramid_launches == p0 + (levels > 1)
        _kernel_e_parity(got, ref, xy, valid)
        assert int(ref.tracked.sum()) > 80


def test_lk_kernel_at_the_coarse_level_size(cuda_device):
    """At 90 x 160 (the coarsest level of a 720p frame), keypoints over the
    whole image and at its edges: kernel E against the plain route, at one
    and two levels and with a smaller patch."""
    img0, img1, _, _ = _lk_pair(cuda_device)
    small0, small1 = (tflow.build_pyramid(im, 3)[2] for im in (img0, img1))
    assert small0.shape == (90, 160)
    rng = np.random.default_rng(3)
    xy = torch.from_numpy(rng.uniform([0, 0], [159, 89], (96, 2)).astype(np.float32)).to(cuda_device)
    valid = torch.ones(96, dtype=torch.bool, device=cuda_device)
    xy, valid = _with_edge_rows(xy, valid, 160, 90)
    for kw in (dict(levels=1), dict(levels=2), dict(levels=2, patch=9, iters=5)):
        got = tflow.lk_track(small0, small1, xy, valid, **kw)
        ref = tflow.lk_track(small0, small1, xy, valid, plain=True, **kw)
        _kernel_e_parity(got, ref, xy, valid)


def test_lk_kernel_refuses_what_it_does_not_take(cuda_device):
    """A patch above MAX_PATCH or even, or too many levels, raise on the card
    before any launch; nothing falls back to the plain route."""
    img0, img1, xy, valid = _lk_pair(cuda_device)
    e0, b0 = tflow.launches, twg.launches
    for kw in (dict(patch=tflow.MAX_PATCH + 2), dict(patch=12), dict(levels=tflow.MAX_LEVELS + 1)):
        with pytest.raises(ValueError, match="lk_track"):
            tflow.lk_track(img0, img1, xy, valid, **kw)
    assert tflow.launches == e0 and twg.launches == b0


@pytest.mark.parametrize(
    "shape, levels",
    [((720, 1280), 4), ((720, 1280), 2), ((720, 1280), 8), ((121, 163), 3), ((725, 1283), 5), ((8, 8), 4),
     ((9, 13), 4), ((90, 160), 1)],
)
def test_pyramid_launch_is_the_plain_pyramid_bitwise(cuda_device, shape, levels):
    """Kernel E's pyramid launch against ``build_pyramid_plain`` on the card,
    for two frames and for one: every level bitwise, at 720p, at odd sizes
    (the crop before the pool), with a top level of 1 px, beyond 4 levels
    (a launch a 3 levels) and at one level (no launch, the frame itself)."""
    rng = np.random.default_rng(levels)
    imgs = [torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32)).to(cuda_device) for _ in range(2)]
    want = [tflow.build_pyramid_plain(img, levels) for img in imgs]
    steps = len(tflow.pyramid_plan(*shape, levels))
    assert steps == -(-(levels - 1) // tflow.PYRAMID_LEVELS_A_LAUNCH)
    for frames in (imgs, imgs[:1]):
        p0 = tflow.pyramid_launches
        got = tflow.build_pyramids(frames, levels)
        assert tflow.pyramid_launches == p0 + steps
        for g, w_ in zip(got, want):
            assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in w_]
            assert all(a.is_contiguous() and torch.equal(a, b) for a, b in zip(g, w_))
    assert torch.equal(tflow.build_pyramid(imgs[0], levels)[-1], want[0][-1])


def test_pyramid_launch_refuses_what_it_does_not_take(cuda_device):
    """An empty level, more than two frames, frames of two shapes: raise
    before any launch."""
    img = torch.zeros((90, 160), device=cuda_device)
    p0 = tflow.pyramid_launches
    for frames, levels in (([img], 9), ([img[:4]], 4), ([img, img, img], 2), ([img, img[:, :80]], 2)):
        with pytest.raises(ValueError, match="build_pyramid"):
            tflow.build_pyramids(frames, levels)
    assert tflow.pyramid_launches == p0


def test_lk_track_and_descriptors_capture_and_replay_bitwise(cuda_device):
    """Kernel E's two launches (``lk_track``) and kernel F
    (``describe_keypoints`` with a scale on the card) captured in one CUDA
    graph: no host read, no allocation outside the capture's pool; a replay
    on new inputs copied into the captured ones gives the eager calls' bits
    on those inputs."""
    img0, img1, xy, valid = _small_step_pair(cuda_device)
    scale = torch.tensor(1.37, device=cuda_device)

    def run():
        flow = tflow.lk_track(img0, img1, xy, valid)
        return flow, tdesc.describe_keypoints(img1, flow.xy, flow.tracked, scale=scale)

    run()   # the eager first call (F's table, the library)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flow, desc = run()
    other0, other1, other_xy, other_valid = _lk_pair(cuda_device)
    for a, b in ((img0, other0[:H, :W]), (img1, other1[:H, :W]), (xy, other_xy), (valid, other_valid)):
        a.copy_(b)
    graph.replay()
    want_flow, want_desc = run()
    torch.cuda.synchronize()
    assert int(want_flow.tracked.sum()) > 80
    assert all(torch.equal(a, b) for a, b in zip(flow, want_flow))
    assert torch.equal(desc, want_desc)


def _klt_run(dev, imgs, cams, intr):
    cfg = SLAMConfig(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96, max_map_rays=1024,
        max_keyframes=16, min_inliers=10, keyframe_interval=6,
    )
    slam = PTZSlam(cfg, intr, device=dev)
    frames = torch.from_numpy(imgs).to(dev)
    xy0, d0, v0 = extract_features(frames[0], slam.cfg)
    state = slam.init(xy0, d0, v0, cams[0])
    b0, e0, f0, p0 = twg.launches, tflow.launches, tdesc.launches, tflow.pyramid_launches
    state, infos, xy, valid = slam.run_segment_pixels_klt(state, frames[1:], frames[0], xy0, v0)
    return slam, state, infos, (twg.launches - b0, tflow.launches - e0, tdesc.launches - f0, tflow.pyramid_launches - p0)


def test_klt_slice_on_card_matches_cpu(cuda_device):
    """KLT mode on the card (kernels A and C-F) and on the CPU: the same
    flags, poses within 5e-4 rad and 2 px, and a frame's launches: one of
    each of kernel E's (the pyramids, the flow), one of kernel F (the
    descriptors) and no window gather."""
    imgs, cams, intr = _render(30)
    imgs = imgs[:14]
    _, _, i_cpu, _ = _klt_run("cpu", imgs, cams, intr)
    _, _, i_gpu, (gathers, flows, descs, pyramids) = _klt_run(cuda_device, imgs, cams, intr)
    assert flows == descs == pyramids == len(imgs) - 1 and gathers == 0
    for name in ("lost", "event", "keyframe"):
        np.testing.assert_array_equal(getattr(i_gpu, name).cpu().numpy(), getattr(i_cpu, name).numpy())
    assert int(i_gpu.keyframe.sum()) >= 2 and not bool(i_gpu.lost.any())
    dpose = np.abs(i_gpu.pose.cpu().numpy() - i_cpu.pose.numpy())
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0


def test_checkpoint_round_trip_of_a_card_state(cuda_device, tmp_path):
    """A state on the card saves and loads back bitwise, onto the device of
    the ``like`` tree's leaves (the card, or the CPU)."""
    imgs, cams, intr = _render(30)
    slam, state, _, _ = _klt_run(cuda_device, imgs[:5], cams, intr)
    path = str(tmp_path / "state.npz")
    tckpt.save_pytree(path, state)
    frame0 = torch.from_numpy(imgs[0])
    like = slam.init(*extract_features(frame0.to(cuda_device), slam.cfg), cams[0])
    back = tckpt.load_pytree(path, like)
    leaves, back_leaves = tckpt.tree_flatten(state)[0], tckpt.tree_flatten(back)[0]
    assert len(leaves) == len(back_leaves) == 24
    for a, b in zip(leaves, back_leaves):
        assert b.device == a.device and torch.equal(a, b)
    host = PTZSlam(slam.cfg, intr, device="cpu")
    on_cpu = tckpt.load_pytree(path, host.init(*extract_features(frame0, host.cfg), cams[0]))
    for a, b in zip(leaves, tckpt.tree_flatten(on_cpu)[0]):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b)


def test_wrappers_reject_bad_inputs(cuda_device):
    img = torch.zeros((40, 60), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        thn.detect_maps(img)                             # float64
    with pytest.raises(ValueError):
        thn.detect_maps(img.float().T)                   # not contiguous
    ok_mask = torch.ones((40, 60), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        thn.detect_maps(img.float(), ok_mask[:, :59])    # mask of another shape
    with pytest.raises(ValueError):
        thn.detect_maps(img.float(), ok_mask.to(torch.uint8))   # mask of another dtype
    with pytest.raises(ValueError):
        thn.detect_maps(img.float(), ok_mask, border=0)  # the kernel needs border >= 1
    idx = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        twg.gather_windows(img.float(), idx, idx, 18)   # int64 starts
    with pytest.raises(ValueError):
        twg.gather_windows(img.float(), idx.int(), idx.int(), 60)   # window larger than image
    d = torch.zeros((4, 8), device=cuda_device)
    ok = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        tkm.match_scores(d, d.double(), ok, ok)          # float64 reference
    with pytest.raises(ValueError):
        tkm.match_scores(d, d, ok.int(), ok)             # int validity
    with pytest.raises(ValueError):
        tkm.match_scores(d, d, ok, ok, d, d, 5.0)        # (4, 8) positions
    with pytest.raises(ValueError):
        tch.cholesky(img.float())                        # not square
    with pytest.raises(ValueError):
        tch.cholesky(torch.eye(4, dtype=torch.float64, device=cuda_device))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize(
    "q,r,gated,mutual",
    [(512, 256, True, True), (300, 700, False, True), (512, 4096, False, False),
     (70, 1, False, True), (5, 300, True, True), (33, 130, False, False),
     (512, 32768, False, False), (130, 1000, True, True)],
)
def test_match_scores_matches_plain(cuda_device, q, r, gated, mutual):
    """Several CTAs and chunks, a ragged last tile, R = 1 and a single query
    block; exact duplicate reference rows and all-invalid query rows. Only
    rows whose top-2 margin is under 1e-6 may pick another index."""
    rng = np.random.default_rng(q + r)
    dr = _unit(rng.normal(size=(r, 128)))
    src = rng.integers(0, r, q)
    dq = _unit(dr[src] + 0.05 * rng.normal(size=(q, 128)))
    if r > 2:
        dr[1] = dr[0]
        dq[0] = dr[0]
    qv = rng.random(q) > 0.1
    qv[-1] = False
    rv = rng.random(r) > 0.1
    xr = rng.uniform(0, 640, (r, 2)).astype(np.float32)
    xq = (xr[src] + rng.normal(0, 30, (q, 2))).astype(np.float32)
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in (dq, dr, qv, rv))
    if gated:
        args += (torch.from_numpy(xq).to(cuda_device), torch.from_numpy(xr).to(cuda_device), 60.0)
    before = tkm.launches
    i1, v1, v2, cb = tkm.match_scores(*args, mutual=mutual)
    assert tkm.launches == before + 1
    p_i1, p_v1, p_v2, p_cb = tkm.match_scores_plain(*args, mutual=mutual)
    torch.testing.assert_close(v1, p_v1, rtol=0, atol=1e-5)
    torch.testing.assert_close(v2, p_v2, rtol=0, atol=1e-5)
    near = ((p_v1 - p_v2) < 1e-6) & (p_v1 > -5e8)
    assert torch.equal(i1[~near], p_i1[~near])
    assert (cb is None) == (not mutual)
    if mutual:
        assert cb.dtype == torch.int32 and cb.shape == (r,)
        assert int((cb != p_cb).sum()) <= int(near.sum())


def test_match_scores_repeatable_across_shapes(cuda_device):
    """Three calls at alternating shapes are bitwise equal call for call: the
    ticket counters the last CTA resets leave no state behind, also when the
    next call's grid differs."""
    rng = np.random.default_rng(7)
    calls = []
    for q, r, gated, mutual in ((512, 256, True, True), (512, 4096, False, False), (33, 130, False, True)):
        dr = _unit(rng.normal(size=(r, 128)))
        dq = _unit(dr[rng.integers(0, r, q)] + 0.05 * rng.normal(size=(q, 128)))
        args = tuple(
            torch.from_numpy(a).to(cuda_device)
            for a in (dq, dr, rng.random(q) > 0.1, rng.random(r) > 0.1)
        )
        if gated:
            xy = torch.from_numpy(rng.uniform(0, 640, (max(q, r), 2)).astype(np.float32)).to(cuda_device)
            args += (xy[:q], xy[:r], 200.0)
        calls.append((args, mutual))
    outs = [[tkm.match_scores(*a, mutual=m) for a, m in calls] for _ in range(3)]
    for first, later in ((outs[0], outs[1]), (outs[0], outs[2])):
        for x, y in zip(first, later):
            for u, v in zip(x, y):
                assert (u is None and v is None) or torch.equal(u, v)


@pytest.mark.parametrize("n", [512, 256, 33, 1, 900, 1024, 64])
def test_cholesky_matches_cusolver(cuda_device, n):
    """The EKF's n = 512 and 256, a ragged last panel, a single pivot, fewer
    block rows than CTAs, and two sizes whose rows do not fit in shared
    memory (the global-memory branch)."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n)).astype(np.float32) * 0.1
    s = torch.from_numpy(a @ a.T + np.eye(n, dtype=np.float32)).to(cuda_device)
    before = tch.launches
    got, info = tch.cholesky(s)
    assert tch.launches == before + 1
    ref, info_p = tch.cholesky_plain(s)
    assert int(info) == int(info_p) == 0 and info.dtype == torch.int32
    assert float((got @ got.T - s).abs().max() / s.abs().max()) < 1e-5
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert not bool(got.triu(1).any())
    bad = s.clone()
    bad[n // 2, n // 2] = -1.0
    assert int(tch.cholesky(bad)[1]) == int(tch.cholesky_plain(bad)[1]) > 0


def test_slice_on_card_matches_cpu(cuda_device):
    """The same code on the card (through the CUDA kernels) and on the CPU
    (plain versions) tracks the same way, keyframe inserts and windowed BA
    included."""
    imgs, cams, intr = _render(30)
    cfg = SLAMConfig(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96, max_map_rays=1024,
        max_keyframes=16, min_inliers=10, keyframe_interval=6,
    )
    out = {}
    for dev in ("cpu", cuda_device):
        slam = PTZSlam(cfg, intr, device=dev)
        frames = torch.from_numpy(imgs[:14]).to(dev)
        state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
        state, infos = slam.run_segment_pixels(state, frames[1:])
        out[str(dev)] = [v.cpu().numpy() for v in (infos.pose, infos.lost, infos.keyframe)]
    (p_cpu, l_cpu, k_cpu), (p_gpu, l_gpu, k_gpu) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(l_gpu, l_cpu)
    np.testing.assert_array_equal(k_gpu, k_cpu)
    assert k_gpu.sum() >= 2 and not l_gpu.any()
    dpose = np.abs(p_gpu - p_cpu)
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0


def _blackout_run(dev, imgs, cams, intr, mode):
    cfg = SLAMConfig(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96, max_map_rays=1024,
        max_keyframes=16, min_inliers=10, keyframe_interval=6, reloc_mode=mode,
    )
    slam = PTZSlam(cfg, intr, device=dev)
    frames = torch.from_numpy(imgs).to(dev)
    counts = (tkm.launches, tch.launches)
    state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
    _, infos = slam.run_segment_pixels(state, frames[1:])
    launched = (tkm.launches - counts[0], tch.launches - counts[1])
    return [v.cpu().numpy() for v in (infos.pose, infos.lost, infos.event, infos.reloc_success, infos.keyframe)], launched


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_blackout_slice_on_card_matches_cpu(cuda_device, mode):
    """Frames 14-17 black: tracking goes lost, relocalizes and recovers, on
    the card (through the matcher and Cholesky kernels) as on the CPU."""
    imgs, cams, intr = _render(30)
    imgs[14:18] = 0.0
    (p_c, l_c, e_c, r_c, _), _ = _blackout_run("cpu", imgs, cams, intr, mode)
    (p_g, l_g, e_g, r_g, k_g), (n_match, n_chol) = _blackout_run(cuda_device, imgs, cams, intr, mode)
    np.testing.assert_array_equal(l_g, l_c)
    np.testing.assert_array_equal(e_g, e_c)
    np.testing.assert_array_equal(r_g, r_c)
    assert l_g[13:17].any() and r_g.any() and not l_g[-8:].any()
    dpose = np.abs(p_g - p_c)
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0
    tracked, relocs = int((e_g == 0).sum()), int((e_g == 1).sum())
    assert n_match == tracked + int(k_g.sum()) + 1 + relocs and n_chol == tracked


def _cli(out, *argv):
    """``ptzjax_torch.run`` in process; (records, summary, result)."""
    import json
    import os

    from ptzjax_torch import run

    res = run.main([*argv, "--out", str(out)])
    with open(os.path.join(out, "summary.json")) as f:
        return res.records, json.load(f), res


def test_cli_runs_on_the_card_by_default(cuda_device, tmp_path):
    """No --device: the loop's state lives on the card, and the per-frame
    records match a --device cpu run of the same sequence."""
    argv = ("--synthetic-images", "--frames", "12", "--width", "480", "--height", "270", "--chunk", "8")
    rec_g, sum_g, res = _cli(tmp_path / "gpu", *argv)
    rec_c, sum_c, _ = _cli(tmp_path / "cpu", *argv, "--device", "cpu")
    assert res.state.ekf.cam.device.type == "cuda"
    assert sorted(sum_g) == sorted(sum_c) and sum_g["frames_lost"] == sum_c["frames_lost"] == 0
    assert [r["lost"] for r in rec_g] == [r["lost"] for r in rec_c]
    dpose = np.abs(np.array([r["pose"] for r in rec_g]) - np.array([r["pose"] for r in rec_c]))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0


def test_forest_reloc_on_card_matches_cpu(cuda_device):
    """``relocalize_rf`` solves on the device of its inputs: the card's pose
    agrees with the CPU's on the same forest prediction."""
    from ptzjax_torch import features, reloc_forest

    seq = synth.make_sequence(num_frames=40, num_rays=900, seed=4)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(900, 32)).astype(np.float32)
    seq = seq._replace(descriptors=d / np.linalg.norm(d, axis=-1, keepdims=True))
    cfg = SLAMConfig(max_keypoints=128, kf_desc_dim=32)
    forest = reloc_forest.RelocForest(seed=7)
    for k in range(0, 40, 10):
        f, ids = features.synth_features(seq, k, 128, desc_noise=0.02)
        rays = np.where((ids >= 0)[:, None], seq.rays[np.clip(ids, 0, None)], 0.0).astype(np.float32)
        forest.add_keyframe(f.desc, rays, valid=f.valid & (ids >= 0))
    f, _ = features.synth_features(seq, 25, 128, desc_noise=0.02, seed=3)
    poses = {}
    for dev in ("cpu", cuda_device):
        res = reloc_forest.relocalize_rf(forest, f.desc, f.xy, f.valid, seq.intr, cfg, device=dev)
        assert bool(res.success) and res.pose.device.type == torch.device(dev).type
        poses[str(dev)] = res.pose.cpu().numpy()
    d = np.abs(poses["cpu"] - poses[str(cuda_device)])
    assert d[:2].max() < 5e-4 and d[2] < 2.0


def test_homography_baseline_on_card_matches_cpu(cuda_device):
    """The baseline over features staged on each device: the card (the
    matcher kernel at 160 x 160, once a frame) takes the CPU's decisions."""
    from ptzjax_torch.baselines import init_vo, track_homography_ekf
    from ptzjax_torch.frontend import extract_sequence

    imgs, cams, intr = _render(12)
    cfg = SLAMConfig(image_width=W, image_height=H, max_keypoints=160, min_inliers=10)
    out = {}
    for dev in ("cpu", cuda_device):
        xy, desc, valid = extract_sequence(imgs, cfg, device=dev)
        state = init_vo(cams[0], xy[0], desc[0], valid[0], cfg)
        before = tkm.launches
        _, infos = track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg)
        out[str(dev)] = [v.cpu().numpy() for v in infos], tkm.launches - before
    (info_c, _), (info_g, n_match) = out["cpu"], out[str(cuda_device)]
    assert n_match == len(imgs) - 1
    np.testing.assert_array_equal(info_g[2], info_c[2])
    np.testing.assert_array_equal(info_g[1], info_c[1])
    assert info_g[2].all()
    dpose = np.abs(info_g[0] - info_c[0])
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0


def test_run_sharded_one_nccl_rank_is_ba_run(cuda_device, tmp_path):
    """A one-rank NCCL group on the card: ``run_sharded`` through a mesh that
    holds the group (its all-reduces and all-gather on NCCL) is bitwise
    ``ba.run`` without one."""
    import torch.distributed as tdist

    from ptzjax_torch import ba, dist
    from ptzjax_torch.geometry import project_rays

    seq = synth.make_sequence(num_frames=60, num_rays=400, seed=2)
    rng = np.random.default_rng(2)
    frames = np.linspace(0, 59, 5).astype(int)
    obs_cam = rng.integers(0, 5, (200, 4)).astype(np.int32)
    rays = seq.rays[:200].astype(np.float32)
    cams = seq.cameras[frames]
    pix = project_rays(
        torch.from_numpy(cams[obs_cam]), torch.from_numpy(rays)[:, None, None, :].expand(200, 4, 1, 2), seq.intr
    )[:, :, 0] + torch.from_numpy(rng.normal(0, 0.5, (200, 4, 2)).astype(np.float32))
    prob = ba.BAProblem(
        cams=torch.from_numpy(cams + rng.normal(0, 2e-3, cams.shape).astype(np.float32)),
        rays=torch.from_numpy(rays + rng.normal(0, 1e-3, rays.shape).astype(np.float32)),
        obs_pix=pix, obs_cam=torch.from_numpy(obs_cam), obs_w=torch.ones((200, 4)),
        cam_free=torch.tensor([False, True, True, True, True]),
    )
    prob = ba.BAProblem(*(v.to(cuda_device) for v in prob))
    dist.initialize_multihost(f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="nccl", timeout_s=60)
    try:
        mesh = dist.Mesh(("obs",), (1,), None, tdist.group.WORLD)
        for huber in (0.0, 2.0):
            cfg = SLAMConfig(ba_iters=10, ba_huber_px=huber)
            want = ba.run_robust(prob, seq.intr, cfg) if huber else ba.run(prob, seq.intr, cfg)
            got = dist.run_sharded(prob, seq.intr, cfg, mesh)
            assert float(want.cost) < float(want.initial_cost)
            for a, b in zip(got, want):
                assert a.device == b.device and torch.equal(a, b)
    finally:
        tdist.destroy_process_group()


def test_torchrun_offline_on_every_card(cuda_device, tmp_path):
    """``torchrun --nproc-per-node <cards> -m ptzjax_torch.run --offline``:
    one process a card, NCCL between them; the records equal the
    one-process run's (each frame's features are those of a per-frame call,
    so tracking is the same), the BA costs within rtol 1e-4. Skips on a
    machine with one card."""
    import json
    import os
    import subprocess
    import sys

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    argv = ["--synthetic-images", "--offline", "--frames", "48", "--width", "640", "--height", "360",
            "--f0", "1100", "--f-amp", "60", "--pan-amp", "0.12"]
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        f.write(SLAMConfig(max_keypoints=256, max_rays=128, keyframe_interval=8).to_json())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for n, launcher in ((cards, ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(cards)]), (1, [])):
        proc = subprocess.run(
            [sys.executable, *launcher, "-m", "ptzjax_torch.run", *argv, "--config", cfg, "--out", str(tmp_path / str(n))],
            capture_output=True, text=True, timeout=600, cwd=root,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(tmp_path / str(n) / "summary.json") as f:
            out[n] = json.load(f), np.load(tmp_path / str(n) / "trajectory.npz")["pose"]
    (s_n, pose_n), (s_1, pose_1) = out[cards], out[1]
    assert s_n["mesh_devices"] == cards and s_1["mesh_devices"] == 1
    assert s_n["frames_lost"] == s_1["frames_lost"] == 0 and s_n["keyframes"] == s_1["keyframes"] >= 2
    np.testing.assert_array_equal(pose_n, pose_1)
    for key in ("ba_cost_before", "ba_cost_after"):
        np.testing.assert_allclose(s_n[key], s_1[key], rtol=1e-4)


# the CUDA-graph route of run_segment_pixels (ptzjax_torch/_graphs.py)


def _bench_frames(num_frames):
    """``bench.py``'s 720p sequence (chip_smoke.py's ``render``)."""
    pano = synth.make_panorama(seed=0)
    intr = Intrinsics.create(640.0, 360.0)
    cams = synth.make_trajectory(
        num_frames, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=2000.0, f_amp=250.0, period=192.0, seed=0
    )
    return np.stack([synth.render_image(pano, c, intr, 1280, 720) for c in cams]).astype(np.float32), cams, intr


def _small_cfg(**kw) -> SLAMConfig:
    """The 640x360 card tests' configuration (at 30 frames it tracks every
    frame; the cadence inserts none before frame 120)."""
    return SLAMConfig(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96, max_map_rays=1024,
        max_keyframes=16, min_inliers=10, **kw,
    )


def _leaves(tree):
    return tckpt.tree_flatten(tree)[0]


def _bitwise(a, b) -> bool:
    """Two trees of tensors equal bit for bit (NaN garbage included)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    return all(torch.equal(bits(x), bits(y)) for x, y in zip(_leaves(a), _leaves(b)))


def _frame_by_frame(slam, state, frames, masks=None, stop=None):
    """One frame a call from frame 1 (to ``stop``): (state, infos as a list)."""
    infos = []
    for f in range(1, stop or frames.shape[0]):
        state, info = slam.run_segment_pixels(state, frames[f:f + 1], None if masks is None else masks[f:f + 1])
        infos.append(info)
    return state, infos


@pytest.mark.parametrize("mode, masked", [("map", False), ("keyframe", False), ("map", True)])
def test_graph_route_is_the_eager_route_bitwise(cuda_device, mode, masked):
    """``bench.py``'s 720p sequence, frames 1-79 one a call (40-79 are 4d's
    tracked frames), through the graph route and through the eager route
    (``_graphs=False``): every FrameInfo and the final state bitwise equal,
    the same launches, one graph captured."""
    imgs, cams, intr = _bench_frames(80)
    frames = torch.from_numpy(imgs).to(cuda_device)
    masks = None
    if masked:
        masks = torch.ones(frames.shape, dtype=torch.bool, device=cuda_device)
        masks[:, 100:300, 200:400] = False
        masks[:, 450:700, 900:1200] = False
    out = {}
    for graphs in (True, False):
        slam = PTZSlam(SLAMConfig(reloc_mode=mode), intr, _graphs=graphs)
        state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
        before = (thn.launches, thn.masked_launches, tkm.launches, tch.launches, tdesc.launches)
        state, infos = _frame_by_frame(slam, state, frames, masks)
        after = (thn.launches, thn.masked_launches, tkm.launches, tch.launches, tdesc.launches)
        out[graphs] = state, infos, tuple(a - b for a, b in zip(after, before)), slam
    (s_g, i_g, n_g, slam_g), (s_e, i_e, n_e, _) = out[True], out[False]
    assert all(_bitwise(a, b) for a, b in zip(i_g, i_e)) and _bitwise(s_g, s_e)
    assert n_g == n_e == (79, 79 if masked else 0, 79, 79, 79)
    assert len(slam_g._graphs.graphs) == 1 and not any(bool(i.lost[0]) for i in i_g)


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_graph_route_inserts_and_relocalizes_as_the_eager_route(cuda_device, mode):
    """The 640x360 blackout sequence with a keyframe every 6 frames, in
    chunks: the eager insert and relocalization frames between replays give
    bitwise the eager route's states and infos."""
    imgs, cams, intr = _render(30)
    imgs[14:18] = 0.0
    cfg = _small_cfg(keyframe_interval=6, reloc_mode=mode)
    frames = torch.from_numpy(imgs).to(cuda_device)
    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
        infos = []
        for a, b in ((1, 5), (5, 6), (6, 16), (16, 30)):
            state, part = slam.run_segment_pixels(state, frames[a:b])
            infos.append(part)
        out[graphs] = state, infos
    (s_g, i_g), (s_e, i_e) = out[True], out[False]
    assert all(_bitwise(a, b) for a, b in zip(i_g, i_e)) and _bitwise(s_g, s_e)
    keyframe = torch.cat([p.keyframe for p in i_e]).cpu().numpy()
    event = torch.cat([p.event for p in i_e]).cpu().numpy()
    assert keyframe.sum() >= 3 and (event == 1).sum() >= 1


def test_graph_route_keeps_the_callers_state_and_replays_a_rewound_one(cuda_device):
    """A call leaves the state it was given bit for bit, returns tensors of
    its own, and a state kept from before (the forest's rewind) replayed
    gives the first run's result."""
    imgs, cams, intr = _render(30)
    cfg = _small_cfg()
    frames = torch.from_numpy(imgs).to(cuda_device)
    slam = PTZSlam(cfg, intr)
    state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
    mid, _ = slam.run_segment_pixels(state, frames[1:8])
    kept = [v.clone() for v in _leaves(mid)]
    end, infos = slam.run_segment_pixels(mid, frames[8:16])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(mid), kept))
    bufs = {v.data_ptr() for g in slam._graphs.graphs.values() for v in _leaves(g.state)}
    assert not bufs & {v.data_ptr() for v in _leaves(end)}
    again, infos2 = slam.run_segment_pixels(mid, frames[8:16])
    assert _bitwise(end, again) and _bitwise(infos, infos2)


def test_graph_replays_credit_the_counters_and_read_the_card_once(cuda_device):
    """Each frame adds one launch of A, C, D and F (and a masked A) to the
    counters, the warm-up and the capture none; a call of one tracked frame
    waits for the card once (sync debug mode), at the call's read."""
    import warnings

    imgs, cams, intr = _render(30)
    cfg = _small_cfg()
    frames = torch.from_numpy(imgs).to(cuda_device)
    masks = torch.ones(frames.shape, dtype=torch.bool, device=cuda_device)
    masks[:, 50:120, 80:200] = False
    slam = PTZSlam(cfg, intr)
    state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
    counters = (thn, "launches"), (thn, "masked_launches"), (tkm, "launches"), (tch, "launches"), (tdesc, "launches")
    before = [getattr(m, a) for m, a in counters]
    state, infos = slam.run_segment_pixels(state, frames[1:12], masks[1:12])
    assert not bool(infos.keyframe.any()) and not bool(infos.lost.any())
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] == [11] * 5
    waits = []
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = slam.run_segment_pixels(state, frames[12:13], masks[12:13])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        waits = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert len(waits) == 1


def test_two_instances_with_live_graphs_do_not_disturb_each_other(cuda_device):
    """Two ``PTZSlam``s with captured graphs on two sequences, their calls
    interleaved: each gives bitwise its eager run."""
    imgs_a, cams_a, intr = _render(30, seed=1)
    imgs_b, cams_b, _ = _render(30, seed=3)
    cfg = _small_cfg()
    seqs = [(torch.from_numpy(i).to(cuda_device), c) for i, c in ((imgs_a, cams_a), (imgs_b, cams_b))]
    want = []
    for frames, cams in seqs:
        slam = PTZSlam(cfg, intr, _graphs=False)
        state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
        want.append(_frame_by_frame(slam, state, frames))
    slams = [PTZSlam(cfg, intr) for _ in seqs]
    states = [s.init(*extract_features(f[0], s.cfg), c[0]) for s, (f, c) in zip(slams, seqs)]
    infos = [[], []]
    for f in range(1, 30):
        for k, (slam, (frames, _)) in enumerate(zip(slams, seqs)):
            states[k], info = slam.run_segment_pixels(states[k], frames[f:f + 1])
            infos[k].append(info)
    for k in range(2):
        assert _bitwise(states[k], want[k][0]) and all(_bitwise(a, b) for a, b in zip(infos[k], want[k][1]))


# the graph routes of run_segment_pixels_klt and run_segment


def _waits(call) -> int:
    """The host's waits for the card during ``call`` (sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _counts():
    return (
        thn.launches, thn.masked_launches, tkm.launches, tch.launches, tdesc.launches, tflow.launches, twg.launches,
        tflow.pyramid_launches,
    )


def _one_frame_calls(slam, state, frames, masks, kind, feats):
    """Frames 1-79 one a call through ``kind`` ("klt": each call seeded
    with the carry the last one returned; "features": ``run_segment`` on
    ``feats``): (state, infos, last (xy, valid), launches, the host's waits
    on each call after the first)."""
    xy, valid = feats[0][0], feats[2][0]
    infos, waits = [], []
    before = _counts()
    for f in range(1, frames.shape[0]):
        def call():
            nonlocal state, xy, valid
            if kind == "klt":
                state, info, xy, valid = slam.run_segment_pixels_klt(
                    state, frames[f:f + 1], frames[f - 1], xy, valid,
                    masks=None if masks is None else masks[f:f + 1],
                )
            else:
                state, info = slam.run_segment(state, *(v[f:f + 1] for v in feats))
            infos.append(info)

        if f == 1:
            call()
        else:
            waits.append(_waits(call))
    return state, infos, (xy, valid), tuple(a - b for a, b in zip(_counts(), before)), waits


@pytest.mark.parametrize(
    "kind, mode, masked",
    [("klt", "map", False), ("klt", "keyframe", False), ("klt", "map", True), ("features", "map", False),
     ("features", "keyframe", False)],
)
def test_klt_and_features_graph_routes_are_the_eager_route_bitwise(cuda_device, kind, mode, masked):
    """``bench.py``'s 720p sequence, frames 1-79 one a call, in KLT mode and
    in features mode (``run_segment`` on the re-detect frontend's features,
    staged), through the graph route and through the eager route
    (``_graphs=False``): every FrameInfo, the final state and the KLT carry
    bitwise equal, the same launches, one graph of the kind captured, and
    one host wait a call (of one tracked frame) on the graph route."""
    imgs, cams, intr = _bench_frames(80)
    frames = torch.from_numpy(imgs).to(cuda_device)
    masks = None
    if masked:
        masks = torch.ones(frames.shape, dtype=torch.bool, device=cuda_device)
        masks[:, 100:300, 200:400] = False
        masks[:, 450:700, 900:1200] = False
    cfg = SLAMConfig(reloc_mode=mode)
    staged = [extract_features(frames[k], cfg, mask=None if masks is None else masks[k]) for k in range(80)]
    feats = tuple(torch.stack([f[i] for f in staged]) for i in range(3))
    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        state = slam.init(*(v[0] for v in feats), cams[0])
        out[graphs] = (*_one_frame_calls(slam, state, frames, masks, kind, feats), slam)
    (s_g, i_g, c_g, n_g, w_g, slam_g), (s_e, i_e, c_e, n_e, _, _) = out[True], out[False]
    assert all(_bitwise(a, b) for a, b in zip(i_g, i_e)) and _bitwise(s_g, s_e)
    assert all(torch.equal(a, b) for a, b in zip(c_g, c_e))
    klt = kind == "klt"
    assert n_g == n_e == (79 * klt, 79 * masked, 79, 79, 79 * klt, 79 * klt, 0, 79 * klt)
    assert [k[0] for k in slam_g._graphs.graphs] == [kind] and not any(bool(i.lost[0]) for i in i_g)
    assert w_g == [1] * 78


@pytest.mark.parametrize("kind", ["klt", "features"])
@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_klt_and_features_graph_routes_insert_and_relocalize_as_the_eager_route(cuda_device, kind, mode):
    """The 640x360 blackout sequence with a keyframe every 6 frames, in
    chunks, in KLT mode (each chunk seeded with the last one's carry) and in
    features mode: the eager insert and relocalization frames between
    replays give bitwise the eager route's states, infos and carry."""
    imgs, cams, intr = _render(30)
    imgs[14:18] = 0.0
    cfg = _small_cfg(keyframe_interval=6, reloc_mode=mode)
    frames = torch.from_numpy(imgs).to(cuda_device)
    staged = [extract_features(frames[k], cfg) for k in range(30)]
    feats = tuple(torch.stack([f[i] for f in staged]) for i in range(3))
    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        state = slam.init(*(v[0] for v in feats), cams[0])
        xy, valid = feats[0][0], feats[2][0]
        infos, carry = [], []
        for a, b in ((1, 5), (5, 6), (6, 16), (16, 30)):
            if kind == "klt":
                state, part, xy, valid = slam.run_segment_pixels_klt(state, frames[a:b], frames[a - 1], xy, valid)
                carry += [xy, valid]
            else:
                state, part = slam.run_segment(state, *(v[a:b] for v in feats))
            infos.append(part)
        out[graphs] = state, infos, carry
    (s_g, i_g, c_g), (s_e, i_e, c_e) = out[True], out[False]
    assert all(_bitwise(a, b) for a, b in zip(i_g, i_e)) and _bitwise(s_g, s_e)
    assert all(torch.equal(a, b) for a, b in zip(c_g, c_e))
    keyframe = torch.cat([p.keyframe for p in i_e]).cpu().numpy()
    event = torch.cat([p.event for p in i_e]).cpu().numpy()
    assert keyframe.sum() >= 3 and (event == 1).sum() >= 1


def test_step_graph_route_is_the_eager_route_and_keeps_the_callers_state(cuda_device):
    """``step`` one frame a call (640x360, 30 frames, through the
    ``process`` that calls it on every third frame): bitwise the eager
    route, the caller's state untouched, one features graph."""
    imgs, cams, intr = _render(30)
    cfg = _small_cfg(keyframe_interval=6)
    frames = torch.from_numpy(imgs).to(cuda_device)
    staged = [extract_features(frames[k], cfg) for k in range(30)]
    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        state = slam.init(*staged[0], cams[0])
        infos = []
        for k in range(1, 30):
            kept = [v.clone() for v in _leaves(state)]
            given = state
            if k % 3:
                state, info = slam.step(state, *staged[k])
            else:
                state, d = slam.process(state, *staged[k])
                info = d["pose"]
            assert all(torch.equal(a, b) for a, b in zip(_leaves(given), kept))
            infos.append(info)
        out[graphs] = state, infos, slam
    (s_g, i_g, slam_g), (s_e, i_e, _) = out[True], out[False]
    assert _bitwise(s_g, s_e)
    for a, b in zip(i_g, i_e):
        assert _bitwise(a, b) if isinstance(a, tuple) else np.array_equal(a.view(np.int32), b.view(np.int32))
    assert [k[0] for k in slam_g._graphs.graphs] == ["features"]


# the insert and lost programs of the graph routes


@functools.lru_cache(maxsize=1)
def _blackout_bench_frames():
    """``bench.py``'s 720p sequence to frame 160 with frames 140-146
    zeroed (chip_smoke.py's 4c): the cadence insert at 120, lost in the
    blackout, relocalized after it."""
    imgs, cams, intr = _bench_frames(161)
    imgs[140:147] = 0.0
    return imgs, cams, intr


def _window_expected(infos, kind, masked) -> tuple:
    """``_counts()``'s launches that the call sites give for a window's
    infos: A and F a frame from pixels (A masked where the frames are), E's
    two launches a KLT frame, C a tracked frame, an insert and a
    relocalization frame, D a tracked frame, B never."""
    event = torch.cat([i.event for i in infos]).cpu().numpy()
    keyframe = torch.cat([i.keyframe for i in infos]).cpu().numpy()
    frames, tracked = len(event), int((event == 0).sum())
    pixels, klt = kind != "features", kind == "klt"
    return (
        frames * pixels, frames * masked, tracked + int(keyframe.sum()) + int((event == 1).sum()),
        tracked, frames * pixels, frames * klt, 0, frames * klt,
    )


@pytest.mark.parametrize(
    "kind, mode, masked",
    [("redetect", "map", False), ("redetect", "keyframe", False), ("redetect", "map", True),
     ("klt", "map", False), ("klt", "keyframe", False), ("klt", "map", True),
     ("features", "map", False), ("features", "keyframe", False)],
)
def test_graph_route_insert_and_lost_programs_are_the_eager_route_bitwise(cuda_device, kind, mode, masked):
    """``bench.py``'s 720p sequence with the 140-146 blackout, frames 1-99
    in one call, then 100-160 one a call (the cadence insert at 120, the
    lost frames and the recovery), in re-detect, KLT and features mode,
    both reloc modes and with a mask: the graph route's FrameInfos, final
    state and KLT carry are bitwise the eager route's, and both launch
    what the call sites give. The same ``PTZSlam`` then runs 100-160 again
    from its kept state at 99, its frame graph captured by then: bitwise
    again, and from frame 101 the host waits once a call, on an insert, a
    lost and a tracked frame alike."""
    imgs, cams, intr = _blackout_bench_frames()
    frames = torch.from_numpy(imgs).to(cuda_device)
    masks = None
    if masked:
        masks = torch.ones(frames.shape, dtype=torch.bool, device=cuda_device)
        masks[:, 100:300, 200:400] = False
        masks[:, 450:700, 900:1200] = False
    cfg = SLAMConfig(reloc_mode=mode)
    feats = None
    if kind == "features":
        staged = [extract_features(frames[k], cfg) for k in range(frames.shape[0])]
        feats = tuple(torch.stack([f[i] for f in staged]) for i in range(3))

    def call(slam, state, carry, a, b):
        m = None if masks is None else masks[a:b]
        if kind == "redetect":
            return (*slam.run_segment_pixels(state, frames[a:b], m), carry)
        if kind == "klt":
            state, info, xy, valid = slam.run_segment_pixels_klt(state, frames[a:b], frames[a - 1], *carry, masks=m)
            return state, info, (xy, valid)
        return (*slam.run_segment(state, *(v[a:b] for v in feats)), carry)

    def window(slam, state, carry, waits=None):
        infos = []
        for f in range(100, 161):
            def one():
                nonlocal state, carry
                state, info, carry = call(slam, state, carry, f, f + 1)
                infos.append(info)

            if waits is None or f == 100:   # 100: the call reads the kept state's lost flag
                one()
            else:
                waits.append(_waits(one))
        return state, infos, carry

    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        first = (v[0] for v in feats) if feats else extract_features(frames[0], slam.cfg, mask=None if masks is None else masks[0])
        xy0, desc0, valid0 = first
        state = slam.init(xy0, desc0, valid0, cams[0])
        state, _, carry = call(slam, state, (xy0, valid0), 1, 100)
        kept = state, carry
        before = _counts()
        result = window(slam, state, carry)
        out[graphs] = (*result, tuple(a - b for a, b in zip(_counts(), before)), slam, kept)
    (s_g, i_g, c_g, n_g, slam_g, kept), (s_e, i_e, c_e, n_e, _, _) = out[True], out[False]
    assert all(_bitwise(a, b) for a, b in zip(i_g, i_e)) and _bitwise(s_g, s_e)
    assert all(torch.equal(a, b) for a, b in zip(c_g, c_e))
    assert n_g == n_e == _window_expected(i_e, kind, masked)
    event = torch.cat([i.event for i in i_e]).cpu().numpy()
    keyframe = torch.cat([i.keyframe for i in i_e]).cpu().numpy()
    assert keyframe[20] and (event == 1).sum() >= 2 and torch.cat([i.reloc_success for i in i_e]).any()
    (g,) = slam_g._graphs.graphs.values()
    assert g.program.replay is not None and g.counts["insert+ba"] == 1 and g.counts["lost"] >= 2
    waits = []
    s_2, i_2, c_2 = window(slam_g, *kept, waits=waits)
    assert all(_bitwise(a, b) for a, b in zip(i_2, i_e)) and _bitwise(s_2, s_e)
    assert all(torch.equal(a, b) for a, b in zip(c_2, c_e))
    want = [1] * len(keyframe[1:])
    assert waits == want, [(101 + f, w, x) for f, (w, x) in enumerate(zip(waits, want)) if w != x]


@pytest.mark.parametrize(
    "kind, mode, masked",
    [("redetect", "map", False), ("redetect", "keyframe", False), ("redetect", "map", True),
     ("klt", "map", False), ("klt", "keyframe", False), ("klt", "map", True),
     ("features", "map", False), ("features", "keyframe", False)],
)
def test_one_call_segment_over_the_window_is_the_eager_route_bitwise(cuda_device, kind, mode, masked):
    """``bench.py``'s 720p sequence with the 140-146 blackout: frames 1-99
    in one call, then 100-160 (the cadence insert at 120, the lost frames
    and the recovery) in one call, in re-detect, KLT and features mode,
    both reloc modes and with a mask: the graph route's FrameInfos, final
    state and KLT carry are bitwise the eager route's (the same calls),
    both launch what the call sites give, the frame graph took each branch
    as often as the infos say, and the window's call waits for the card
    once (sync debug mode)."""
    imgs, cams, intr = _blackout_bench_frames()
    frames = torch.from_numpy(imgs).to(cuda_device)
    masks = None
    if masked:
        masks = torch.ones(frames.shape, dtype=torch.bool, device=cuda_device)
        masks[:, 100:300, 200:400] = False
        masks[:, 450:700, 900:1200] = False
    cfg = SLAMConfig(reloc_mode=mode)
    feats = None
    if kind == "features":
        staged = [extract_features(frames[k], cfg) for k in range(frames.shape[0])]
        feats = tuple(torch.stack([f[i] for f in staged]) for i in range(3))

    def call(slam, state, carry, a, b):
        m = None if masks is None else masks[a:b]
        if kind == "redetect":
            return (*slam.run_segment_pixels(state, frames[a:b], m), carry)
        if kind == "klt":
            state, info, xy, valid = slam.run_segment_pixels_klt(state, frames[a:b], frames[a - 1], *carry, masks=m)
            return state, info, (xy, valid)
        return (*slam.run_segment(state, *(v[a:b] for v in feats)), carry)

    out = {}
    for graphs in (True, False):
        slam = PTZSlam(cfg, intr, _graphs=graphs)
        first = (v[0] for v in feats) if feats else extract_features(frames[0], slam.cfg, mask=None if masks is None else masks[0])
        xy0, desc0, valid0 = first
        state = slam.init(xy0, desc0, valid0, cams[0])
        state, _, carry = call(slam, state, (xy0, valid0), 1, 100)
        before = _counts()
        result = []
        waits = _waits(lambda: result.extend(call(slam, state, carry, 100, 161)))
        out[graphs] = (*result, tuple(a - b for a, b in zip(_counts(), before)), waits, slam)
    (s_g, i_g, c_g, n_g, w_g, slam_g), (s_e, i_e, c_e, n_e, _, _) = out[True], out[False]
    assert _bitwise(i_g, i_e) and _bitwise(s_g, s_e)
    assert all(torch.equal(a, b) for a, b in zip(c_g, c_e))
    assert n_g == n_e == _window_expected([i_e], kind, masked)
    event, keyframe = i_e.event.cpu().numpy(), i_e.keyframe.cpu().numpy()
    assert keyframe[20] and (event == 1).sum() >= 2 and bool(i_e.reloc_success.any())
    (g,) = slam_g._graphs.graphs.values()
    taken = dict(zip(("lost", "track", "insert+ba", "insert"), g.taken.tolist()))
    assert taken == {"lost": int((event == 1).sum()), "track": int((event == 0).sum()), "insert+ba": 1, "insert": 0}
    assert w_g == 1


def test_baseline_graph_route_is_the_eager_route_bitwise(cuda_device):
    """``track_homography_ekf`` on the 640x360 sequence's features, frames
    1-29 in one call: the graph route (the first frame eager, the rest
    replays of one graph) gives bitwise the eager route's infos and final
    carry, and launches C once a frame on both."""
    from ptzjax_torch import baselines as tbase

    imgs, cams, intr = _render(30)
    cfg = _small_cfg()
    frames = torch.from_numpy(imgs).to(cuda_device)
    staged = [extract_features(frames[k], cfg) for k in range(30)]
    xy, desc, valid = (torch.stack([f[i] for f in staged]) for i in range(3))
    out = {}
    for graphs in (True, False):
        state = tbase.init_vo(cams[0], xy[0], desc[0], valid[0], cfg)
        before = tkm.launches
        out[graphs] = (*tbase.track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg, _graphs=graphs),
                       tkm.launches - before)
    (s_g, i_g, n_g), (s_e, i_e, n_e) = out[True], out[False]
    assert _bitwise(i_g, i_e) and _bitwise(s_g, s_e) and n_g == n_e == 29
    assert bool(i_g.updated.all())


def test_soak_graph_route_is_the_eager_route_bitwise_at_small_caps(cuda_device, tmp_path):
    """``soak.run_soak`` over 288 frames of a 96-frame periodic stack at
    640x360 with tests/test_torch_soak.py's caps (4 keyframes, a keyframe
    every 8 frames, 112 map rays, culls after 10 frames): on the graph route
    every insert is the frame graph's captured insert branch, and at the
    cap it evicts. Both routes write the same frames.jsonl and bitwise the
    same checkpoints; both resume bitwise."""
    from ptzjax_torch import soak

    cams = soak.trajectory(96, f0=1000.0, f_amp=125.0)
    imgs, intr = soak.render_stack(cams, W, H)
    cfg = _small_cfg().replace(
        max_map_rays=112, max_keyframes=4, keyframe_interval=8, ray_cull_age=10, descriptor_f_ref=1000.0
    )
    runs = {}
    for graphs in (True, False):
        out = tmp_path / str(graphs)
        summary = soak.run_soak(
            cfg, intr, imgs, cams, frames=288, chunk=24, checkpoint_every=96, out=str(out), device=cuda_device,
            _graphs=graphs,
        )
        runs[graphs] = (summary, (out / "frames.jsonl").read_text(), out)
    (s_g, log_g, out_g), (s_e, log_e, out_e) = runs[True], runs[False]
    assert log_g == log_e
    occupancy = [
        [{k: o[k] for k in ("frame", "map_rays", "keyframes", "ekf_slots")} for o in s["occupancy_checkpoints"]]
        for s in (s_g, s_e)
    ]
    assert occupancy[0] == occupancy[1]   # the memory readings differ between routes
    for frame in (96, 192, 288):
        with np.load(out_g / f"state_{frame:06d}.npz") as a, np.load(out_e / f"state_{frame:06d}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].tobytes() == b[key].tobytes(), (frame, key)
    assert s_g["keyframe_evictions"] == s_e["keyframe_evictions"] >= 1
    assert s_g["peak_map_rays"] == cfg.max_map_rays and s_g["frames_lost"] == 0
    assert s_g["resume"]["bitwise"] and s_e["resume"]["bitwise"]
    assert s_g["pass"]["memory"]


def test_host_read_in_the_insert_program_makes_its_capture_raise(cuda_device, monkeypatch):
    """A host read put inside the insert branch: the frame graph's warm-up
    (eager) runs, the capture of its insert branch raises naming it, and so
    does the next call; nothing falls back to the eager route."""
    from ptzjax_torch import slam as tslam

    imgs, cams, intr = _render(30)
    cfg = _small_cfg(keyframe_interval=6)
    frames = torch.from_numpy(imgs).to(cuda_device)
    slam = PTZSlam(cfg, intr)
    state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
    step = tslam._insert_step

    def reading_step(*args, **kw):
        out = step(*args, **kw)
        bool(out.lost)
        return out

    monkeypatch.setattr(tslam, "_insert_step", reading_step)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="the frame graph's 'insert\\+ba' branch failed"):
            slam.run_segment_pixels(state, frames[1:12])
    (g,) = slam._graphs.graphs.values()
    assert g.program.replay is None


def test_host_read_in_the_captured_step_makes_the_capture_raise(cuda_device, monkeypatch):
    """A host read put inside the step: the frame graph's warm-up (eager)
    runs, the capture of its track branch raises naming it, and so does the
    next call; nothing falls back to the eager route. Last in the file: it
    leaves a failed capture behind."""
    from ptzjax_torch import slam as tslam

    imgs, cams, intr = _render(30)
    cfg = _small_cfg()
    frames = torch.from_numpy(imgs).to(cuda_device)
    slam = PTZSlam(cfg, intr)
    state = slam.init(*extract_features(frames[0], slam.cfg), cams[0])
    step = tslam._track_step

    def reading_step(*args, **kw):
        out = step(*args, **kw)
        bool(out[2][0])
        return out

    monkeypatch.setattr(tslam, "_track_step", reading_step)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="the frame graph's 'track' branch failed"):
            slam.run_segment_pixels(state, frames[1:3])
    assert all(g.program.replay is None for g in slam._graphs.graphs.values())
