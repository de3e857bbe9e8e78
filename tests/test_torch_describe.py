"""The identities kernel F (``csrc/describe.cu``) is built on, pinned on the
CPU with the port's plain descriptor code, and the plain route held to
``ptzjax``'s ``describe_keypoints`` (its jnp path, ``use_pallas=False``),
and an ill-conditioned corner row held to a float64 descriptor. F itself runs only on a card: tests/test_torch_cuda.py holds it to the plain
route there."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax.kernels import descriptor as jdesc
from ptzjax_torch.kernels import descriptor as tdesc
from ptzjax_torch.kernels import window_gather as twg
from tests._torch_port import n, t, texture

torch.set_num_threads(2)

SCALES = (0.4, 1.0, 1.37, 2.5)   # both clamp ends, unit spacing, a zoom


def _inputs():
    """tests/test_torch_kernels.py's 120 x 200 texture and 37 keypoints with
    its two corner rows, two rows far off the image, and invalid rows (one
    of them NaN)."""
    img = texture(h=120, w=200, seed=7)
    rng = np.random.default_rng(7)
    xy = np.stack([rng.uniform(1.0, 199.0, 37), rng.uniform(1.0, 119.0, 37)], -1).astype(np.float32)
    xy[:4] = [[0.2, 0.3], [198.9, 118.7], [1e9, -1e9], [-3e5, 7e4]]
    xy[-1] = [np.nan, 50.0]
    valid = np.ones((37,), bool)
    valid[-2:] = False
    return img, xy, valid


@pytest.mark.parametrize("win", [tdesc.PATCH + 2, tdesc.SCALED_WIN])
def test_clamped_read_equals_the_padded_gather(win):
    """F reads the unpadded image at clamped rows and columns; that is the
    padded copy's window, bit for bit, at the corners and far off too."""
    img, xy, _ = _inputs()
    xy = t(xy[:-1])
    rows, cols = tdesc._window_pixels(*img.shape, xy, win)
    assert rows.shape == cols.shape == (xy.shape[0], win + 1)
    clamped = t(img)[rows[:, :, None], cols[:, None, :]]
    pimg, ys, xs, _, _ = tdesc._window_starts(t(img), xy, win)
    padded = twg.gather_windows(pimg, ys, xs, win)
    assert torch.equal(clamped, padded)


@pytest.mark.parametrize("scale", SCALES)
def test_two_tap_resample_equals_the_dense_product(scale):
    """Each row of ``_resample_matrix`` has two nonzeros, at floor(pos) and
    floor(pos) + 1, both inside the window; F's taps, computed by the same
    formula, are those entries bit for bit, and the separable 2-tap
    resample (y, then x) is the dense einsum within 1e-6."""
    img, xy, _ = _inputs()
    windows = tdesc._extract_aligned(t(img), t(xy[:-1]), tdesc.SCALED_WIN)
    s = torch.tensor(scale, dtype=torch.float32)
    side = tdesc.PATCH + 2
    r = tdesc._resample_matrix(s, side, tdesc.SCALED_WIN)
    pos = (torch.arange(side, dtype=torch.float32) - (side - 1) / 2.0) * s + (tdesc.SCALED_WIN - 1) / 2.0
    j0 = torch.floor(pos).to(torch.int64)
    assert int(j0.min()) >= 0 and int(j0.max()) + 1 <= tdesc.SCALED_WIN - 1
    w0 = (1.0 - (pos - j0.float()).abs()).clamp(0.0, 1.0)
    w1 = (1.0 - (pos - (j0 + 1).float()).abs()).clamp(0.0, 1.0)
    i = torch.arange(side)
    assert torch.equal(r[i, j0], w0) and torch.equal(r[i, j0 + 1], w1)
    rest = r.clone()
    rest[i, j0] = 0.0
    rest[i, j0 + 1] = 0.0
    assert not bool(rest.any())
    rows = windows[:, j0, :] * w0[:, None] + windows[:, j0 + 1, :] * w1[:, None]   # (K, 18, 46)
    taps = rows[:, :, j0] * w0 + rows[:, :, j0 + 1] * w1                          # (K, 18, 18)
    dense = torch.einsum("iw,kwv,jv->kij", r, windows, r)
    torch.testing.assert_close(taps, dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale", [None, 1.37])
def test_fixed_order_bin_sums_equal_the_histogram_einsum(scale):
    """F sums each of the 128 bins over the 256 pixels in index order; those
    sums are the plain version's einsum within 1e-6."""
    img, xy, _ = _inputs()
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    mag, ori_w = tdesc._orientation_bins(tdesc._aligned_samples(t(img), t(xy[:-1]), s))
    spatial = tdesc._spatial_weights(torch.device("cpu"))
    hist = torch.einsum("kp,pc,kpo->kco", mag, spatial, ori_w)
    acc = torch.zeros_like(hist)
    for p in range(tdesc.PATCH * tdesc.PATCH):
        acc = acc + (mag[:, p, None, None] * spatial[p, None, :, None]) * ori_w[:, p, None, :]
    assert float(hist.abs().max()) > 0.1
    torch.testing.assert_close(acc, hist, rtol=0, atol=1e-6)


def _pixel_bins(sub: torch.Tensor):
    """``_orientation_bins``' magnitude, fractional bin and lower bin (K,
    P*P) each, by its own formulas."""
    gxs = (0.5 * (sub[:, 1:-1, 2:] - sub[:, 1:-1, :-2])).reshape(-1, tdesc.PATCH * tdesc.PATCH)
    gys = (0.5 * (sub[:, 2:, 1:-1] - sub[:, :-2, 1:-1])).reshape(-1, tdesc.PATCH * tdesc.PATCH)
    mag = torch.sqrt(gxs * gxs + gys * gys + 1e-12)
    b = (torch.atan2(gys, gxs) / (2.0 * math.pi) + 0.5) * tdesc.ORI_BINS
    b0 = torch.floor(b)
    return mag, b - b0, torch.remainder(b0.to(torch.int32), tdesc.ORI_BINS)


def _cell_span(c: int) -> tuple[int, int]:
    """The patch rows (and columns) lo..hi inclusive where cell row (or
    column) c's bilinear weight is positive (csrc/describe.cu's cell_lo,
    cell_hi)."""
    return max(4 * c - 2, 0), min(4 * c + 5, tdesc.PATCH - 1)


def _nonzero_bin_sums(mag, fb, lower, spatial):
    """Kernel F's histogram (csrc/describe.cu) in torch: bin (cell, o) sums
    (mag_p w_pc) x (1 - fb_p or fb_p) over its cell's rectangle in index
    order, only where o is pixel p's lower or upper orientation bin;
    every bin NaN where a magnitude or a fractional bin of the patch is not
    finite."""
    k = mag.shape[0]
    hist = torch.zeros((k, tdesc.CELLS * tdesc.CELLS, tdesc.ORI_BINS))
    bins = torch.arange(tdesc.ORI_BINS)
    for cy in range(tdesc.CELLS):
        for cx in range(tdesc.CELLS):
            (r0, r1), (q0, q1) = _cell_span(cy), _cell_span(cx)
            c = cy * tdesc.CELLS + cx
            acc = hist[:, c]
            for r in range(r0, r1 + 1):
                for q in range(q0, q1 + 1):
                    p = r * tdesc.PATCH + q
                    x = (mag[:, p] * spatial[p, c])[:, None]
                    lo = lower[:, p, None] == bins
                    hi = torch.remainder(lower[:, p, None] + 1, tdesc.ORI_BINS) == bins
                    f = fb[:, p, None]
                    acc = torch.where(lo, acc + x * (1.0 - f), torch.where(hi, acc + x * f, acc))
            hist[:, c] = acc
    bad = ~(torch.isfinite(mag) & torch.isfinite(fb)).all(-1)
    hist[bad] = float("nan")
    return hist


@pytest.mark.parametrize("scale", [None, 1.37])
def test_nonzero_term_bin_sums_equal_the_full_loop(scale):
    """F's histogram, each bin over its cell's nonzero spatial weights and
    its own orientation bins only (784 of the table's 4,096 entries, 2 of
    the 8 bins), is the in-order loop over all 256 pixels bit for bit on
    finite inputs (the terms left out are exact zeros); the cells'
    rectangles are exactly the table's nonzeros. With an infinite or NaN pixel in a patch,
    that row is all NaN after the normalization, as the full loop's is, and
    the other rows keep their bits."""
    img, xy, _ = _inputs()
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    spatial = tdesc._spatial_weights(torch.device("cpu"))
    rectangles = torch.zeros_like(spatial, dtype=torch.bool)
    for cy in range(tdesc.CELLS):
        for cx in range(tdesc.CELLS):
            (r0, r1), (q0, q1) = _cell_span(cy), _cell_span(cx)
            grid = torch.zeros((tdesc.PATCH, tdesc.PATCH), dtype=torch.bool)
            grid[r0 : r1 + 1, q0 : q1 + 1] = True
            rectangles[:, cy * tdesc.CELLS + cx] = grid.reshape(-1)
    assert torch.equal(rectangles, spatial != 0) and int(rectangles.sum()) == 784
    bad = img.copy()
    x0, y0 = int(xy[5, 0]), int(xy[5, 1])
    bad[y0, x0] = np.inf
    x1, y1 = int(xy[6, 0]), int(xy[6, 1])
    bad[y1, x1] = np.nan
    for image, broken in ((img, ()), (bad, (5, 6))):
        sub = tdesc._aligned_samples(t(image), t(xy[:-1]), s)
        mag, fb, lower = _pixel_bins(sub)
        mag_p, ori_w = tdesc._orientation_bins(sub)
        torch.testing.assert_close(mag, mag_p, rtol=0, atol=0, equal_nan=True)
        full = torch.zeros((mag.shape[0], tdesc.CELLS * tdesc.CELLS, tdesc.ORI_BINS))
        for p in range(tdesc.PATCH * tdesc.PATCH):
            full = full + (mag_p[:, p, None, None] * spatial[p, None, :, None]) * ori_w[:, p, None, :]
        model = _nonzero_bin_sums(mag, fb, lower, spatial)
        finite = (torch.isfinite(mag) & torch.isfinite(fb)).all(-1)
        assert not bool(finite[list(broken)].any()) and int(finite.sum()) >= 30
        assert torch.equal(model[finite], full[finite])
        if broken:
            for hist in (model, full):
                desc = tdesc._normalize(hist.reshape(-1, tdesc.DESC_DIM))
                assert bool(torch.isnan(desc[~finite]).all()) and bool(torch.isfinite(desc[finite]).all())


def test_spatial_weights_computed_once_per_device():
    """The table is built once per device and reused (the plain route and F
    read the same bits); it equals a fresh computation bitwise."""
    tdesc._spatial_weights.cache_clear()
    cpu = torch.device("cpu")
    first = tdesc._spatial_weights(cpu)
    img, xy, valid = _inputs()
    tdesc.describe_keypoints(t(img), t(xy), t(valid))
    assert tdesc._spatial_weights(cpu) is first
    assert tdesc._spatial_weights.cache_info().misses == 1
    fresh = tdesc._spatial_weights.__wrapped__(cpu)
    assert fresh is not first and torch.equal(fresh, first)
    assert first.shape == (tdesc.PATCH * tdesc.PATCH, tdesc.CELLS * tdesc.CELLS) and first.is_contiguous()


@pytest.mark.parametrize("scale", [None, *SCALES])
def test_plain_flag_on_cpu_and_parity_with_the_reference(scale):
    """On the CPU ``plain=True`` is the default call bit for bit (neither
    launches a kernel), and both are within 1e-5 of ``ptzjax``'s
    descriptors, corner and far-off rows included; invalid rows are zeros."""
    img, xy, valid = _inputs()
    s = None if scale is None else torch.tensor(scale, dtype=torch.float32)
    f0, b0 = tdesc.launches, twg.launches
    got = tdesc.describe_keypoints(t(img), t(xy), t(valid), scale=s)
    plain = tdesc.describe_keypoints(t(img), t(xy), t(valid), scale=s, plain=True)
    assert tdesc.launches == f0 and twg.launches == b0
    assert torch.equal(got, plain)
    ref = jdesc.describe_keypoints(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid),
        scale=None if scale is None else jnp.asarray(scale, jnp.float32),
    )
    np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(got)[-2:], 0.0)
    assert np.isfinite(n(got)).all()


def _float64_descriptor(img: np.ndarray, x: float, y: float, s: float):
    """One keypoint's descriptor in float64, from the definition: the
    edge-padded window, the 4-shift blend and the dense resample in numpy,
    then gradients, soft bins, histogram and normalization as a torch float64
    function of the 18 x 18 aligned samples (so that its Jacobian is at
    hand). Returns (descriptor, samples, that function, the window's largest
    pixel)."""
    p, win = tdesc.PATCH, tdesc.SCALED_WIN
    half, pad = win // 2, win // 2 + 1
    h, w = img.shape
    y0, x0 = math.floor(y + 0.5), math.floor(x + 0.5)
    fy, fx = min(max(y + 0.5 - y0, 0.0), 1.0), min(max(x + 0.5 - x0, 0.0), 1.0)
    ys = min(max(y0 - half + pad, 0), h + 2 * pad - win - 1)
    xs = min(max(x0 - half + pad, 0), w + 2 * pad - win - 1)
    win_px = np.pad(img.astype(np.float64), pad, mode="edge")[ys : ys + win + 1, xs : xs + win + 1]
    blended = (
        win_px[:-1, :-1] * (1 - fy) * (1 - fx) + win_px[:-1, 1:] * (1 - fy) * fx
        + win_px[1:, :-1] * fy * (1 - fx) + win_px[1:, 1:] * fy * fx
    )
    pos = (np.arange(p + 2) - (p + 1) / 2.0) * s + (win - 1) / 2.0
    r = np.clip(1.0 - np.abs(pos[:, None] - np.arange(win)[None, :]), 0.0, 1.0)
    samples = torch.tensor(r @ blended @ r.T)

    off = np.arange(p) - (p - 1) / 2.0
    dy, dx = (a.reshape(-1) for a in np.meshgrid(off, off, indexing="ij"))
    cy, cx = (dy + p / 2.0) / (p / tdesc.CELLS) - 0.5, (dx + p / 2.0) / (p / tdesc.CELLS) - 0.5
    gauss = np.exp(-(dx * dx + dy * dy) / (2.0 * (p / 2.0) ** 2))
    spatial = torch.tensor(np.stack(
        [np.clip(1 - abs(cy - a), 0, 1) * np.clip(1 - abs(cx - b), 0, 1) * gauss
         for a in range(tdesc.CELLS) for b in range(tdesc.CELLS)], -1,
    ))

    def describe(sub: torch.Tensor) -> torch.Tensor:
        gx = (0.5 * (sub[1:-1, 2:] - sub[1:-1, :-2])).reshape(-1)
        gy = (0.5 * (sub[2:, 1:-1] - sub[:-2, 1:-1])).reshape(-1)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
        b = (torch.atan2(gy, gx) / (2 * math.pi) + 0.5) * tdesc.ORI_BINS
        b0 = torch.floor(b)
        i0 = torch.remainder(b0.long(), tdesc.ORI_BINS)
        one = torch.nn.functional.one_hot
        ori_w = one(i0, tdesc.ORI_BINS) * (1 - (b - b0))[:, None] + one(
            torch.remainder(i0 + 1, tdesc.ORI_BINS), tdesc.ORI_BINS
        ) * (b - b0)[:, None]
        d = torch.einsum("p,pc,po->co", mag, spatial, ori_w).reshape(-1)
        d = (d / d.norm()).clamp_max(0.2)
        return d / d.norm()

    return describe(samples), samples, describe, float(np.abs(win_px).max())


@pytest.mark.parametrize("scale", [0.4, 1.0, 2.5])
def test_corner_row_within_its_fp32_conditioning(scale):
    """A keypoint at the image's corner column and last row, (0.0, 119.4): at
    scale 0.4 its 18 x 18 grid spans 7 pixels of a near-flat edge-padded
    patch, so its gradients are differences of nearly equal samples. The
    fp32 descriptor is held to a float64 one within a first-order bound
    from the descriptor's conditioning: each aligned sample off by two unit
    roundoffs of the window's largest pixel (the blend's and the
    resample's), times the float64 Jacobian's absolute row sums, plus two
    unit roundoffs for the steps after the samples. At 0.4 the row is
    700-1,600x worse conditioned than at 1.0 and 2.5, and the bound is
    ~4e-4 there (the port is ~1e-5 off); at 1.0 and 2.5 it is under 1e-6."""
    img, _, _ = _inputs()
    xy = np.array([[0.0, 119.4]], np.float32)
    s32 = np.float32(scale)
    want, samples, describe, peak = _float64_descriptor(img, float(xy[0, 0]), float(xy[0, 1]), float(s32))
    jac = torch.autograd.functional.jacobian(describe, samples).reshape(tdesc.DESC_DIM, -1)
    u = 2.0 ** -24
    bound = 2 * u * (peak * jac.abs().sum(1) + 1)
    got = tdesc.describe_keypoints(t(img), t(xy), torch.tensor([True]), scale=torch.tensor(s32))
    err = (got[0].double() - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), f"max err {float(err.max())}, bound there {float(bound[err.argmax()])}"


def test_refuses_other_devices_and_a_cpu_image_for_the_kernel():
    """An image on neither the CPU nor CUDA raises; kernel F's wrapper
    refuses a CPU image instead of taking the plain version."""
    img, xy, valid = _inputs()
    meta = [torch.empty(a.shape, dtype=torch.float32 if a.dtype != bool else torch.bool, device="meta") for a in (img, xy, valid)]
    with pytest.raises(ValueError, match="describe_keypoints"):
        tdesc.describe_keypoints(*meta)
    f0 = tdesc.launches
    with pytest.raises(ValueError, match="CUDA"):
        tdesc.describe_kernel(t(img), t(xy), t(valid))
    assert tdesc.launches == f0
