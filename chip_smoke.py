"""Drive the ptzjax_torch main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --detect-stage`` prints only phases 1-2 and the
detection-stage line of 3a, through the public ``detect_keypoints``, so a
copy of this script placed at the root of an earlier checkout measures that
checkout's detection stage.)

Phases, each of which raises (non-zero exit) on failure:

1. device and flags: a CUDA device is required (no CPU fallback); both TF32
   flags are set to False; the card's name and power limit are printed;
2. build: the CUDA kernels are compiled from ``ptzjax_torch/csrc`` with nvcc;
3. kernel vs plain torch on the card, at the main path's shapes: (a) the
   detection maps (Harris, NMS, mask, border, subpixel fit, floor) on a
   720p frame with no mask and with a mask of three boxes, bitwise (sup and
   floor everywhere, off at the survivors), then the whole
   ``detect_keypoints`` call: device time and kernels per call; (b) the
   window gather, 512 windows at win 46 and 18; (c) the matcher at 512 x 256
   gated at 60 px (tracking), 512 x
   2,048 (the matcher bench shape), 512 x 4,096 mutual (map relocalization)
   and 512 x 32,768 one-way (keyframe relocalization), each call exactly one
   kernel, and three calls bitwise equal at 512 x 32,768 and 512 x 256;
   (d) the Cholesky factor at n = 512 and 256 (rows in shared memory) and
   1,024 (rows in global memory), and its failure flag on a non-PD input.
   For each: the event time of back-to-back calls (host work included),
   the device time (the profiler's kernel durations), the bound (the
   larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32) and
   the share of it reached, and for D the time of ``torch.linalg.cholesky_ex``;
4. the slice: ``bench.py``'s 720p sequence, continued from 120 to 192
   frames (one full period of its pan sweep) so that the product defaults'
   keyframe policy inserts keyframes (at 120 frames it inserts none),
   through ``PTZSlam.init`` + ``run_segment_pixels`` at the SLAMConfig
   product defaults, on the card. (a) The first frames must agree with the
   same code run on the CPU (``device="cpu"``, plain versions). (b) The
   whole sequence: the kernel launch counters must equal the counts the call sites give (detection and
   windows once per frame, the matcher once per tracked frame and per
   keyframe insert, the Cholesky once per tracked frame), no frame may be
   lost, the pan error against ground truth must stay under 3e-3 rad and
   windowed BA must have run. (c) The same sequence with frames 140-146
   (after the frame-120 cadence insert) blacked out, once per
   ``reloc_mode`` ("map", "keyframe"): tracking must go lost in the
   blackout, relocalize, track every frame from 15 frames after it with a
   pan error under 3e-3 rad, and the counters must again equal the call
   sites' counts (the matcher also once per relocalization frame). (d) The
   4c sequence again, in each reloc mode, over 40 tracked frames and the
   relocalization frames: wall time per frame (one pass) and device time and
   kernels per frame (a second pass, under the profiler).

The line before the last is one JSON object with the kernels' numbers
(``launches`` from run 4b, ``launches_by_path`` from 4b and both 4c runs);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM fp32 outside the tensor cores, flop/s


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what sets it): the least time the card could take to move
    ``nbytes`` and do ``ops`` fp32 operations."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# Seconds the profiled window stays open around the work: without it the
# profiler now and then hands back only part of a batch's kernel records,
# or none, although every kernel ran.
PROFILER_PAD_S = 0.05


@contextlib.contextmanager
def profiled():
    """A CUDA-only profiler session padded by PROFILER_PAD_S on each side,
    synchronized before it closes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)


def device_kernels(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_time(fn, batch: int = 50, per_call: int | None = None, tries: int = 4) -> tuple[float, dict]:
    """(device ms per call, {kernel name: count}) from the profiler's CUDA
    kernel records over ``batch`` calls after a warm-up. The profiler may
    lose records but never adds any, so a short session is profiled again:
    the answer is the first session with ``per_call * batch`` records or,
    where ``per_call`` is not known, with as many as the session before it.
    More records than ``per_call * batch`` fail at once."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    last = None
    for attempt in range(tries):
        with profiled() as prof:
            for _ in range(batch):
                fn()
        kernels = device_kernels(prof)
        names: dict = {}
        for e in kernels:
            names[e.name] = names.get(e.name, 0) + 1
        n = len(kernels)
        if per_call is not None:
            check(n <= per_call * batch, f"{len(names)} kernel names, {n / batch} kernels per call: {names}")
            done = n == per_call * batch
        else:
            done = n > 0 and n == last
        if done:
            total_us = sum(e.time_range.elapsed_us() for e in kernels)
            return total_us / batch / 1e3, names
        if last is not None or per_call is not None:
            print(f"profiler: {n} kernel records from {batch} calls (session {attempt + 1}); profiling again")
        last = n
    raise RuntimeError(f"chip_smoke: no two profiler sessions of {batch} calls agreed (last {last} records)")


def timings(fn, plain, nbytes: float, ops: float, library=None) -> dict:
    """Event and device times of the kernel ``fn`` (one kernel a call, which
    ``device_time`` checks), its plain version, and the one-call library
    equivalent where there is one, with the bound."""
    dev_ms, names = device_time(fn, per_call=1)
    check(len(names) == 1, f"{len(names)} kernel names in one kernel a call: {names}")
    b_ms, b_by = bound(nbytes, ops)
    out = {
        "ms": time_ms(fn), "device_ms": dev_ms, "plain_ms": time_ms(plain),
        "plain_device_ms": device_time(plain)[0], "bound_ms": b_ms, "bound_by": b_by,
        "bound_share": b_ms / dev_ms,
        "library_ms": None if library is None else time_ms(library),
    }
    return out


def describe(t: dict) -> str:
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    return (
        f"kernel {t['ms']:.4f} ms event, {t['device_ms']:.4f} ms device (one kernel a call); "
        f"bound {t['bound_ms']:.5f} ms by {t['bound_by']}, {100 * t['bound_share']:.2f}% of it; "
        f"plain {t['plain_ms']:.4f} ms event, {t['plain_device_ms']:.4f} ms device; library {lib}"
    )


def time_ms(fn, reps: int = 5, batch: int = 50) -> float:
    """Median over ``reps`` of the CUDA-event time of ``batch`` back-to-back
    calls, per call, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def render(frames: int, w: int, h: int):
    """``bench.py``'s sequence (its trajectory has period 120 * 1.6 = 192
    frames), ``frames`` long: a 720p pan/zoom sweep over a seeded
    panorama."""
    from ptzjax_torch import synth
    from ptzjax_torch.geometry import Intrinsics

    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(seed=0)
    cams = synth.make_trajectory(
        frames, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=2000.0, f_amp=250.0,
        period=192.0, seed=0,
    )
    imgs = np.stack([synth.render_image(pano, c, intr, w, h) for c in cams])
    return imgs.astype(np.float32), cams, intr


def detect_stage_line(img: torch.Tensor, card: str) -> str:
    """The whole ``detect_keypoints`` call on a 720p frame at the SLAMConfig
    defaults (512 keypoints, no mask): event and device time, and device
    kernels per call. Uses only the public function, so the same code
    measures an earlier checkout (``--detect-stage``)."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.kernels.detect import detect_keypoints

    cfg = SLAMConfig()

    def call():
        return detect_keypoints(img, cfg.max_keypoints, threshold=cfg.detector_threshold)

    dev_ms, names = device_time(call)
    per_call = sum(names.values()) / 50
    return (
        f"detect_keypoints stage 720x1280, {cfg.max_keypoints} keypoints: {dev_ms:.4f} ms device, "
        f"{per_call:g} kernels a call, {time_ms(call):.4f} ms event [{card}]"
    )


def kernel_phase(img: torch.Tensor, card: str) -> list[dict]:
    """Each kernel against its plain version on the card, at main-path
    shapes."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.kernels import harris_nms as hn
    from ptzjax_torch.kernels import window_gather as wg
    from ptzjax_torch.kernels.descriptor import PATCH, SCALED_WIN, _window_starts

    # A: the detection maps (Harris, NMS, mask, border, subpixel fit and
    # floor) on a 720p frame at the SLAMConfig defaults, with no mask and
    # with a mask of a few rectangular boxes: bitwise against the plain
    # version (sup and floor everywhere, off at the survivors)
    h, w = img.shape
    thr = SLAMConfig().detector_threshold
    boxes = torch.ones((h, w), dtype=torch.bool, device=img.device)
    for y0, y1, x0, x1 in ((100, 300, 200, 400), (450, 700, 900, 1200), (0, 120, 1100, 1280)):
        boxes[y0:y1, x0:x1] = False
    harris = {}
    for name, mask in (("no mask", None), ("3 boxes", boxes)):
        sup, off, floor = hn.detect_maps(img, mask, 8, thr)
        p_sup, p_off, p_floor = hn.detect_maps_plain(img, mask, 8, thr)
        torch.cuda.synchronize()
        keep = p_sup > -1e29
        survivors = int(keep.sum())
        check(torch.equal(sup, p_sup), f"detect_maps ({name}): sup is not bitwise equal")
        check(torch.equal(floor, p_floor), f"detect_maps ({name}): floor {float(floor)} != {float(p_floor)}")
        check(torch.equal(off[keep], p_off[keep]), f"detect_maps ({name}): off differs at survivors")
        check(survivors > 1000, f"detect_maps ({name}): only {survivors} survivors")
        # the image read, sup written (and the mask read) once, 8 B of off
        # per survivor and the floor; 78 fp32 operations a pixel (2
        # differences and 2 scalings, 3 products, 2 x 3 five-tap passes of 5
        # multiplies and 4 adds, 7 for the response, 10 for the NMS) and 14
        # for each survivor's fit
        nbytes = 8 * h * w + (h * w if mask is not None else 0) + 8 * survivors + 4
        harris[name] = timings(
            lambda: hn.detect_maps(img, mask, 8, thr), lambda: hn.detect_maps_plain(img, mask, 8, thr),
            nbytes, 78 * h * w + 14 * survivors,
        )
        harris[name]["max_abs_err"] = float((sup - p_sup).abs().max())
        print(
            f"detect_maps 720x1280 ({name}): {survivors} survivors, sup, floor and off at the "
            f"survivors bitwise equal; {describe(harris[name])} [{card}]"
        )
    print(detect_stage_line(img, card))

    # B: 512 windows at win 46 (per frame) and 18 (bootstrap), bitwise
    rng = np.random.default_rng(0)
    gather = {}
    for win in (SCALED_WIN, PATCH + 2):
        xy = np.stack([rng.uniform(0, w - 1, 512), rng.uniform(0, h - 1, 512)], -1)
        xy_d = torch.from_numpy(xy.astype(np.float32)).to(img.device)
        pimg, ys, xs, _, _ = _window_starts(img, xy_d, win)
        out_k = wg.gather_windows(pimg, ys, xs, win)
        out_p = wg.gather_windows_plain(pimg, ys, xs, win)
        torch.cuda.synchronize()
        check(tuple(out_k.shape) == (512, win + 1, win + 1), f"gather shape {tuple(out_k.shape)}")
        check(torch.equal(out_k, out_p), f"gather_windows win {win} is not bitwise equal")
        # the pixels the windows cover, each read once, the windows written
        # once, and the starts read
        side = win + 1
        hp, wp = pimg.shape
        r = torch.arange(side, device=img.device)
        yy = ys.long().clamp(0, hp - side)[:, None] + r
        xx = xs.long().clamp(0, wp - side)[:, None] + r
        covered = torch.unique((yy[:, :, None] * wp + xx[:, None, :]).reshape(-1)).numel()
        gather[win] = timings(
            lambda: wg.gather_windows(pimg, ys, xs, win),
            lambda: wg.gather_windows_plain(pimg, ys, xs, win),
            4 * (covered + out_k.numel() + 2 * ys.numel()), 0,
        )
        gather[win]["max_abs_err"] = float((out_k - out_p).abs().max())
        print(f"gather_windows K=512 win={win}: bitwise equal; {describe(gather[win])} [{card}]")
    return [
        {
            "name": "harris_nms", "route": "cuda",
            "source": "ptzjax_torch/csrc/harris_nms.cu",
            "replaces": "ptzjax/kernels/detect_pallas.py:106",
            **harris["no mask"], "ms_by_shape": harris,
        },
        {
            "name": "gather_windows", "route": "cuda",
            "source": "ptzjax_torch/csrc/gather_windows.cu",
            "replaces": "ptzjax/kernels/window_pallas.py:67",
            **gather[SCALED_WIN],
            "max_abs_err": max(v["max_abs_err"] for v in gather.values()),
            "ms_by_shape": {f"win={k}": v for k, v in gather.items()},
        },
    ]


def run_slice(imgs: torch.Tensor, cams, intr, reloc_mode: str = "map"):
    """``PTZSlam.init`` on frame 0, then ``run_segment_pixels`` on the rest,
    at the product defaults (descriptor_f_ref AUTO), on the device of
    ``imgs``."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    slam = PTZSlam(SLAMConfig(reloc_mode=reloc_mode), intr, device=imgs.device)
    state = slam.init(*extract_features(imgs[0], slam.cfg), cams[0])
    return slam.run_segment_pixels(state, imgs[1:])


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


REPEAT_SHAPES = ("512x256 gated 60px", "512x32768 one-way")


def matcher_phase(dev, card: str) -> dict:
    """Kernel C against its plain version at the path's four shapes, on unit
    random descriptors with planted correspondences, exact duplicate
    reference rows and all-invalid query rows. Indices may differ only
    where a top-2 margin is under 1e-6 (the kernel sums each dot product in
    another order than cuBLAS)."""
    from ptzjax_torch import match as matchlib
    from ptzjax_torch.kernels import match as km

    rng = np.random.default_rng(1)
    d_dim = 128
    shapes = (   # (name, Q, R, gated, mutual, ratio of the call site)
        ("512x256 gated 60px", 512, 256, True, True, 0.95),
        ("512x2048", 512, 2048, False, True, 0.8),
        ("512x4096 mutual", 512, 4096, False, True, 0.8),
        ("512x32768 one-way", 512, 32768, False, False, 0.8),
    )
    errs, by_shape = [], {}
    for name, q, r, gated, mutual, ratio in shapes:
        dr = _unit(rng.normal(size=(r, 128)))
        src = rng.integers(0, r - 1, q)
        dq = _unit(dr[src] + 0.05 * rng.normal(size=(q, 128)))
        dr[src[:16] + 1] = dr[src[:16]]           # exact duplicates of matched rows
        q_valid = rng.random(q) > 0.1
        q_valid[-4:] = False                      # all-invalid rows
        r_valid = rng.random(r) > 0.05
        xr = rng.uniform([0, 0], [1280, 720], (r, 2)).astype(np.float32)
        xq = (xr[src] + rng.normal(0, 20, (q, 2))).astype(np.float32)
        args = tuple(torch.from_numpy(a).to(dev) for a in (dq, dr, q_valid, r_valid))
        if gated:
            args += (torch.from_numpy(xq).to(dev), torch.from_numpy(xr).to(dev), 60.0)
        got = km.match_scores(*args, mutual=mutual)
        ref = km.match_scores_plain(*args, mutual=mutual)
        torch.cuda.synchronize()
        i1, v1, v2, cb = got
        p_i1, p_v1, p_v2, p_cb = ref
        torch.testing.assert_close(v1, p_v1, rtol=0, atol=1e-5)
        torch.testing.assert_close(v2, p_v2, rtol=0, atol=1e-5)
        # a top-2 margin under 1e-6 on a row with a candidate; rows with none
        # (all -1e9) must agree exactly
        near = ((p_v1 - p_v2) < 1e-6) & (p_v1 > -5e8)
        check(torch.equal(i1[~near], p_i1[~near]), f"matcher {name}: i1 differs outside the margin")
        n_rows_near, n_cols_near = int(near.sum()), 0
        if mutual:
            s = torch.where(args[2][:, None] & args[3][None, :], args[0] @ args[1].T, -1e9)
            if gated:
                d2 = ((args[4][:, None, :] - args[5][None, :, :]) ** 2).sum(-1)
                s = torch.where(d2 <= 60.0 * 60.0, s, -1e9)
            top = torch.topk(s, 2, dim=0).values
            col_near = ((top[0] - top[1]) < 1e-6) & (top[0] > -5e8)
            n_cols_near = int(col_near.sum())
            check(torch.equal(cb[~col_near], p_cb[~col_near]), f"matcher {name}: col_best differs outside the margin")
            near = near | col_near[p_i1.long()]
        res_k = matchlib._decide(args[2], *got, ratio, 0.5, gated)
        res_p = matchlib._decide(args[2], *ref, ratio, 0.5, gated)
        check(
            torch.equal(res_k.ok[~near], res_p.ok[~near]) and torch.equal(res_k.idx[~near], res_p.idx[~near]),
            f"matcher {name}: ok/idx differ outside the margin",
        )
        err = max(float((v1 - p_v1).abs().max()), float((v2 - p_v2).abs().max()))
        errs.append(err)
        repeat = ""
        if name in REPEAT_SHAPES:
            # the ticket counters reset themselves: later calls are bitwise
            # the same
            for _ in range(2):
                again = km.match_scores(*args, mutual=mutual)
                check(
                    all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)),
                    f"matcher {name}: a repeated call differs",
                )
            repeat = "three calls bitwise equal; "
        # 2 Q R D flops; the descriptors, validity (and positions) read once,
        # the per-row (and per-column) results written once
        nbytes = (
            4 * (q + r) * d_dim + (q + r) + (8 * (q + r) if gated else 0)
            + 12 * q + (4 * r if mutual else 0)
        )
        by_shape[name] = timings(
            lambda: km.match_scores(*args, mutual=mutual),
            lambda: km.match_scores_plain(*args, mutual=mutual),
            nbytes, 2 * q * r * d_dim,
        )
        print(
            f"match_scores {name}: rows within the 1e-6 margin {n_rows_near}, columns "
            f"{n_cols_near}; ok {int(res_k.ok.sum())}/{q}; v1/v2 max_abs_err {err} (atol 1e-5); "
            f"i1, col_best, ok, idx equal outside the margin; {repeat}{describe(by_shape[name])} [{card}]"
        )
    return {
        "name": "match_scores", "route": "cuda", "source": "ptzjax_torch/csrc/match.cu",
        "replaces": "ptzjax/kernels/match.py:88", **by_shape[shapes[0][0]],
        "max_abs_err": max(errs), "ms_by_shape": by_shape,
    }


def cholesky_phase(dev, card: str) -> dict:
    """Kernel D against ``torch.linalg.cholesky_ex`` on SPD matrices scaled
    like the EKF's innovation matrix (eigenvalues from sigma_obs^2 = 1 to
    1e3 px^2), at n = 512 (the default caps) and 256 (128 rays), whose rows
    stay in the cluster's shared memory, and 1,024, whose rows do not."""
    from ptzjax_torch.kernels import cholesky as kc

    rng = np.random.default_rng(2)
    errs, times = [], {}
    for n in (512, 256, 1024):
        u, _ = np.linalg.qr(rng.normal(size=(n, n)))
        lam = np.exp(rng.uniform(0.0, np.log(1e3), n))
        s = torch.from_numpy(((u * lam) @ u.T).astype(np.float32)).to(dev)
        s = 0.5 * (s + s.T)
        lk, info = kc.cholesky(s)
        lp, info_p = kc.cholesky_plain(s)
        torch.cuda.synchronize()
        check(int(info) == 0 and int(info_p) == 0, f"cholesky n={n}: info {int(info)}, plain {int(info_p)}")
        rec = float((lk @ lk.T - s).abs().max() / s.abs().max())
        check(rec < 1e-5, f"cholesky n={n}: reconstruction error {rec}")
        scale = float(lp.abs().max())
        # rtol 1e-4 of the largest entry: entries near zero differ by fp32
        # summation order, which an elementwise rtol would count as failure
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4 * scale)
        check(not bool(lk.triu(1).any()), f"cholesky n={n}: nonzero above the diagonal")
        bad = s.clone()
        bad[n // 3, n // 3] = -1.0
        _, info_k = kc.cholesky(bad)
        _, info_b = kc.cholesky_plain(bad)
        check(
            int(info_k) == int(info_b) > 0,
            f"cholesky n={n}: non-PD info {int(info_k)}, plain {int(info_b)}",
        )
        err = float((lk - lp).abs().max())
        errs.append(err)
        # n^3 / 3 flops; the lower triangle read once, L written once; the
        # plain version is the library call (cuSOLVER through cholesky_ex)
        times[n] = timings(
            lambda: kc.cholesky(s), lambda: kc.cholesky_plain(s),
            4 * (n * (n + 1) // 2 + n * n) + 4, n**3 / 3,
            library=lambda: torch.linalg.cholesky_ex(s),
        )
        print(
            f"cholesky n={n} ({'shared' if kc.plan(n).smem else 'global'}-memory rows): "
            f"reconstruction {rec} (< 1e-5), L max_abs_err {err} vs cuSOLVER (max|L| {scale}, "
            f"tolerance 1e-4 of it), non-PD info {int(info_k)} (plain {int(info_b)}); "
            f"{describe(times[n])} [{card}]"
        )
    return {
        "name": "cholesky", "route": "cuda", "source": "ptzjax_torch/csrc/cholesky.cu",
        "replaces": "ptzjax/kernels/cholesky_pallas.py:139", **times[512],
        "max_abs_err": max(errs), "ms_by_shape": {f"n={n}": t for n, t in times.items()},
    }


KERNEL_MODULES = ("harris_nms", "window_gather", "match", "cholesky")
COUNTER_NAMES = ("harris_nms", "gather_windows", "match_scores", "cholesky")


def reset_counts() -> None:
    for mod in KERNEL_MODULES:
        importlib.import_module(f"ptzjax_torch.kernels.{mod}").launches = 0


def read_counts() -> dict:
    return {
        name: importlib.import_module(f"ptzjax_torch.kernels.{mod}").launches
        for mod, name in zip(KERNEL_MODULES, COUNTER_NAMES)
    }


def expected_counts(infos) -> dict:
    """What the call sites launch in ``run_slice``: detection and windows on
    every frame (``init``'s included), the matcher on every tracked frame,
    every keyframe insert (the bootstrap's included) and every
    relocalization frame, the Cholesky on every tracked frame."""
    event = infos.event.cpu().numpy()
    tracked, relocs = int((event == 0).sum()), int((event == 1).sum())
    inserts = int(infos.keyframe.sum())
    frames = len(event) + 1
    return {
        "harris_nms": frames, "gather_windows": frames,
        "match_scores": tracked + inserts + 1 + relocs, "cholesky": tracked,
    }


BLACKOUT = range(140, 147)   # 7 frames after the frame-120 cadence insert


def blackout_phase(imgs: torch.Tensor, cams, intr, mode: str, card: str) -> dict:
    """4c: the sequence with the BLACKOUT frames zeroed; tracking must go
    lost, relocalize and recover. Returns the run's launch counts."""
    frames = imgs.shape[0]
    dark = imgs.clone()
    dark[BLACKOUT.start:BLACKOUT.stop] = 0.0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = run_slice(dark, cams, intr, reloc_mode=mode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = expected_counts(infos)
    idx = np.arange(1, frames)                       # frame number of each FrameInfo
    lost = infos.lost.cpu().numpy()
    event = infos.event.cpu().numpy()
    success = infos.reloc_success.cpu().numpy()
    pose = infos.pose.cpu().numpy()
    recovered = idx[(event == 1) & success]
    print(
        f"blackout frames {BLACKOUT.start}-{BLACKOUT.stop - 1}, reloc_mode={mode}: lost frames "
        f"{idx[lost].tolist()}, relocalizations {int((event == 1).sum())} (successful at "
        f"{recovered.tolist()}), keyframe inserts {int(infos.keyframe.sum())}; launches {counts}"
    )
    check(lost[np.isin(idx, list(BLACKOUT))].any(), f"{mode}: no frame lost in the blackout")
    check(len(recovered) >= 1, f"{mode}: no successful relocalization")
    first = int(recovered[0])
    late = idx >= BLACKOUT.stop + 15
    check(not lost[late].any(), f"{mode}: lost frames after recovery at {idx[late & lost]}")
    after = (idx > first) & (event == 0)
    pan_mae = float(np.abs(pose[after, 0] - cams[idx[after], 0]).mean())
    check(np.isfinite(pose).all(), f"{mode}: poses not finite")
    check(pan_mae < 3e-3, f"{mode}: pan MAE after recovery {pan_mae} >= 3e-3")
    check(counts == want, f"{mode}: launches {counts}, call sites give {want}")
    print(
        f"blackout reloc_mode={mode}: first recovered frame {first}, pan MAE over the "
        f"{int(after.sum())} tracked frames after it {pan_mae} rad; wall {wall:.3f} s, "
        f"{frames / wall:.2f} frames/s [{card}]"
    )
    return counts


def frame_phase(imgs: torch.Tensor, cams, intr, card: str) -> None:
    """4d: device time and wall time per frame kind, over 40 tracked frames
    (40-79) and the relocalization frames (141-147) of the 4c sequence, in
    each reloc mode. Frames in a window run one per call with a sync after
    each; one pass times their wall clock, a second pass runs the profiler
    over them (its per-launch cost would swell a wall time)."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    dark = imgs.clone()
    dark[BLACKOUT.start:BLACKOUT.stop] = 0.0
    # (kind, frames, event): no frame of either window inserts a keyframe
    windows = (
        ("tracked", range(40, 80), 0),
        ("reloc", range(BLACKOUT.start + 1, BLACKOUT.stop + 1), 1),
    )

    def run(mode: str, traced: bool) -> dict:
        slam = PTZSlam(SLAMConfig(reloc_mode=mode), intr)   # the card, by default
        state = slam.init(*extract_features(dark[0], slam.cfg), cams[0])
        at, out = 1, {}
        for kind, frames, event in windows:
            state, _ = slam.run_segment_pixels(state, dark[at:frames.start])
            torch.cuda.synchronize()
            at = frames.stop
            walls, events = [], []
            with profiled() if traced else contextlib.nullcontext() as prof:
                for f in frames:
                    t0 = time.perf_counter()
                    state, info = slam.run_segment_pixels(state, dark[f:f + 1])
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    events.append(int(info.event[0]) + 2 * int(info.keyframe[0]))
            check(all(e == event for e in events), f"4d {mode}: frames {frames} ran events {events}")
            if not traced:
                out[kind] = float(np.median(walls)) * 1e3
                continue
            kernels = device_kernels(prof)
            check(kernels, "the profiler recorded no device time")
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            out[kind] = (
                sum(by_name.values()) / len(frames) / 1e3, len(kernels) / len(frames),
                sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
            )
        return out

    for mode in ("map", "keyframe"):
        walls, traced = run(mode, False), run(mode, True)
        for kind, frames, _ in windows:
            device_ms, per_frame, top = traced[kind]
            nf = len(frames)
            print(
                f"4d {kind} frames {frames.start}-{frames.stop - 1} (no keyframe insert), "
                f"reloc_mode={mode}: wall median {walls[kind]:.3f} ms, device {device_ms:.4f} ms a "
                f"frame ({per_frame:.1f} kernels, busy {100 * device_ms / walls[kind]:.1f}%); largest: "
                + "; ".join(f"{name[:60]} {us / nf / 1e3:.4f} ms" for name, us in top)
                + f" [{card}]"
            )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    from ptzjax_torch.kernels import _build

    # 1. device and flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = smi
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    if "--detect-stage" in sys.argv[1:]:
        imgs_np, _, _ = render(1, 1280, 720)
        print(detect_stage_line(torch.from_numpy(imgs_np[0]).to(dev), card))
        return 0

    # 3. kernels vs plain at main-path shapes
    w, h, frames = 1280, 720, 192
    imgs_np, cams, intr = render(frames, w, h)
    imgs = torch.from_numpy(imgs_np).to(dev)
    kernels = kernel_phase(imgs[0], card)
    kernels.append(matcher_phase(dev, card))
    kernels.append(cholesky_phase(dev, card))

    # 4a. the first frames through the same code on the CPU (plain
    # versions) and on the card: the reference check on a small input
    n_ref = 8
    _, info_cpu = run_slice(torch.from_numpy(imgs_np[:n_ref]), cams, intr)
    _, info_gpu = run_slice(imgs[:n_ref], cams, intr)
    torch.cuda.synchronize()
    p_cpu, p_gpu = info_cpu.pose.numpy(), info_gpu.pose.cpu().numpy()
    dpose = np.abs(p_cpu - p_gpu)
    check(np.array_equal(info_cpu.lost.numpy(), info_gpu.lost.cpu().numpy()), "CPU/GPU lost flags differ")
    check(dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, f"CPU/GPU poses differ by {dpose.max(0)}")
    print(f"first {n_ref} frames, card vs CPU: max |d pan,tilt| {dpose[:, :2].max()} rad, max |d f| {dpose[:, 2].max()} px")

    # 4b. the main path, counted: each kernel as often as its call sites say
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, infos = run_slice(imgs, cams, intr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = expected_counts(infos)
    print(f"launches over the {frames}-frame main path: {launches}")
    check(launches == want, f"launches {launches}, call sites give {want}")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")

    pose = infos.pose.cpu().numpy()
    lost = infos.lost.cpu().numpy()
    event = infos.event.cpu().numpy()
    inserts = int(infos.keyframe.sum())
    check(pose.shape == (frames - 1, 3) and np.isfinite(pose).all(), "poses not finite / wrong shape")
    pan_mae = float(np.abs(pose[:, 0] - cams[1:, 0]).mean())
    tilt_mae = float(np.abs(pose[:, 1] - cams[1:, 1]).mean())
    f_mae = float(np.abs(pose[:, 2] - cams[1:, 2]).mean())
    print(
        f"slice: {frames} frames 720p at SLAMConfig defaults: lost {int(lost.sum())}, "
        f"keyframe inserts {inserts} (each with windowed BA), relocalizations "
        f"{int((event == 1).sum())}, kf stored {int(state.kf.count)}, "
        f"pan MAE {pan_mae} rad, tilt MAE {tilt_mae} rad, f MAE {f_mae} px"
    )
    print(f"slice wall clock: {wall:.3f} s, {frames / wall:.2f} frames/s [{card}]")
    check(not lost.any(), f"lost frames at {np.nonzero(lost)[0]}")
    check(pan_mae < 3e-3, f"pan MAE {pan_mae} >= 3e-3")
    check(inserts >= 1 and int(state.kf.count) >= 2, "no keyframe insert ran windowed BA")

    # 4c. blackout, relocalization and recovery, in both reloc modes
    by_path = {"main": launches}
    for mode in ("map", "keyframe"):
        by_path[f"blackout_{mode}"] = blackout_phase(imgs, cams, intr, mode, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}

    # 4d. device time per frame kind (after the counted runs)
    frame_phase(imgs, cams, intr, card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
