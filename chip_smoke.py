"""Drive the ptzjax_torch main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --detect-stage`` prints only phases 1-2 and the
detection-stage line of 3a, through the public ``detect_keypoints``, so a
copy of this script placed at the root of an earlier checkout measures that
checkout's detection stage; ``--frame-walls`` likewise prints only the wall
medians of 4d's tracked frames in re-detect, KLT and features mode, through
the public entry points.)

Phases, each of which raises (non-zero exit) on failure. They run in the
order 1, 2, 4a-4c, 4e, the wall passes of 4d, 4h, 4g, 5a-5f, 5h, 5g, then the phases
that use the profiler: 3a-3f, the profiled passes of 4d, 4f and 5e's frames.
After a profiler session a launch of a graph with conditional nodes makes
the host wait for the card, so every wall of the graph route is taken
before the first one; the profiled passes reuse ``PTZSlam``s whose graphs were made
before it (the kernels of a conditional body in a graph made after one were
traced with inflated times, or not at all).

1. device and flags: a CUDA device is required (no CPU fallback); both TF32
   flags are set to False; the card's name and power limit are printed;
2. build: the CUDA kernels are compiled from ``ptzjax_torch/csrc`` with nvcc;
3. kernel vs plain torch on the card, at the main path's shapes: (a) the
   detection maps (Harris, NMS, mask, border, subpixel fit, floor) on a
   720p frame with no mask and with a mask of three boxes, bitwise (sup and
   floor everywhere, off at the survivors), then the whole
   ``detect_keypoints`` call: device time and kernels per call; (b) the
   window gather, which only the plain routes still launch: 512 windows at
   win 46 and 18 (``describe_keypoints``) and at the LK shapes: sides 16
   and 24 at 720p and side 24 at the 90 x 160 level;
   (c) the matcher at 512 x 256
   gated at 60 px (tracking), 512 x 512 mutual and ungated (the homography
   baseline, frame to frame), 512 x
   2,048 (the matcher bench shape), 512 x 4,096 mutual (map relocalization)
   and 512 x 32,768 one-way (keyframe relocalization), each call exactly one
   kernel, and three calls bitwise equal at 512 x 32,768 and 512 x 256;
   (d) the Cholesky factor at n = 512 and 256 (rows in shared memory) and
   1,024 (rows in global memory), and its failure flag on a non-PD input.
   For each: the event time of back-to-back calls (host work included),
   the device time (the profiler's kernel durations), the bound (the
   larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32) and
   the share of it reached, and for D the time of ``torch.linalg.cholesky_ex``;
   (e) the LK stage: ``lk_track`` at the LK bench shape (a 720p pair, 512
   keypoints, 4 levels, the backward check) through kernel E (a pyramid
   launch and an LK launch a call, no window gather) against the plain
   route on the card and against the CPU (``tracked`` equal, ``xy`` within
   1e-3 px on tracked rows), the pyramid launch's levels bitwise the plain
   pyramids'; each launch alone beside its plain version (event and device
   time, bound, share); the whole call's device time, kernels a call (2:
   no torch kernel) and event time; (f) the descriptor stage: ``describe_keypoints`` on
   frame 1 of the sequence at 512 detected keypoints (the last 4 rows made
   invalid, one of them NaN) through kernel F (one launch and no window
   gather a call) against the plain route on the card (B's windows and
   torch), at 4b's frame-1 scale, 1/2.5, 1.0, 1.37, 2.5 and None: within
   1e-5 a component, zeros on the invalid rows, three calls bitwise equal;
   with a NaN pixel at one keypoint, that row all NaN on both routes and
   the others F's within 1e-5 where the plain route's are finite;
   F's event and device time, bound and share beside the plain route's for
   both routes; the whole call's device time, kernels a call and event
   time through F and through the plain route;
4. the slice: ``bench.py``'s 720p sequence, continued from 120 to 192
   frames (one full period of its pan sweep) so that the product defaults'
   keyframe policy inserts keyframes (at 120 frames it inserts none),
   through ``PTZSlam.init`` + ``run_segment_pixels`` at the SLAMConfig
   product defaults, on the card. (a) The first frames must agree with the
   same code run on the CPU (``device="cpu"``, plain versions), in
   re-detect and in KLT mode. (b) The
   whole sequence: the kernel launch counters must equal the counts the call sites give (detection and
   the descriptors once per frame, no window gather, the matcher once per tracked frame and per
   keyframe insert, the Cholesky once per tracked frame), no frame may be
   lost, the pan error against ground truth must stay under 3e-3 rad and
   windowed BA must have run; printed twice, with the same gates: the
   first pass with its frame graph's captures, then a second pass of the
   sequence on the same ``PTZSlam`` (its frame graph captured: the steady
   state), whose poses must equal the first's; both passes' frames/s and
   the frame graph's set-up. (c) The same sequence with frames 140-146
   (after the frame-120 cadence insert) blacked out, once per
   ``reloc_mode`` ("map", "keyframe"): tracking must go lost in the
   blackout, relocalize, track every frame from 15 frames after it with a
   pan error under 3e-3 rad, and the counters must again equal the call
   sites' counts (the matcher also once per relocalization frame). (d) The
   4c sequence again, in each reloc mode, through the graph route (the
   default: each frame kind the replay of its CUDA graphs) and the eager
   route (``PTZSlam(..., _graphs=False)``) in turns, over 40 tracked
   frames, the insert frame (120, ten times from the same state) and the
   relocalization frames, each window's first frame run once before it
   (so that the frame graph is captured before the clock), one frame a
   call, then on the graph route each window in one call (wall a frame,
   busy share), with the frame graph's set-up (captures, assembly,
   instantiation) and pool growth; and
   the same 40 tracked frames in KLT
   mode and in features mode (``run_segment`` on the re-detect frontend's
   features, staged before the clock as ``--offline`` stages them), each
   through the graph route (each tracked frame a replay) and the eager
   route in turns: wall time per frame (passes with their launches
   counted: one of each kernel a KLT frame, C and D a features frame) and
   device time and kernels per frame (a pass under the profiler); each
   graph's capture and instantiation time. (e) The whole sequence in KLT
   mode (``init``
   + ``run_segment_pixels_klt`` seeded with frame 0's features): no lost
   frame, pan MAE < 3e-3 rad, windowed BA ran, the counters equal to the
   call sites' counts (kernel E's pyramid and LK launches once each a KLT
   frame, kernel F once at ``init``
   and once a frame for the descriptors, no window gather),
   ``eval.evaluate_run``'s
   report. (f) ``PTZSlam.bundle_adjust``
   on 4b's final state, plain and robust (cost after <= cost before,
   finite), and ``ba.run`` / ``ba.run_robust`` on the BA bench problem (32
   cameras, 4,096 rays, 24,576 observations, 20 LM iterations) beside
   scipy's fp64 solver. (g) 4b's sequence to frame 96, ``save_pytree``,
   ``load_pytree`` into a fresh state, frames 97 on: flags and poses
   bitwise those of the uninterrupted 4b run. (h) The graph route against
   the eager route over frames 100-160 of the 4c sequence (the insert at
   120, the blackout, the relocalization), one frame a call, in re-detect,
   KLT and features mode, in map mode, in keyframe mode and (re-detect,
   KLT) with a mask of three boxes, the graph route three times on one
   ``PTZSlam`` from its kept state at 99 (twice one frame a call, then the
   window in one call): every FrameInfo, the final state and the KLT carry
   bitwise equal, the same launches, which are the call sites', the
   branches the frame graph took, and the host's waits for the card (sync
   debug mode): 1 a call on every frame kind, 1 for the one-call pass.

5. the CLI (``ptzjax_torch.run``) on the card, each run with the counters
   set to 0 just before it and read just after: (a) ``run.main`` in-process
   on ``--synthetic-images`` at 1280x720, 192 frames, bench.py's trajectory
   flags, the SLAMConfig defaults, ``--ba`` and ``--checkpoint-every 64``:
   no lost frame, pan MAE < 3e-3 rad, 191 lines of ``frames.jsonl``, the
   checkpoints, the BA cost not raised, the counters equal to the call
   sites' counts for its records, and its fps; the same in ``--klt`` mode
   at 96 frames. (b) ``--movers 8`` (masked) at 720p, 96 frames: no lost
   frame, every detection launch carrying its mask. (c) The 4c blackout
   sequence through the CLI's loop (``run.run_sequence``) with ``--reloc
   forest``: keyframes train the forest online, the blackout goes lost,
   the forest relocalizes on the host within 2 frames of the blackout's
   end, no frame is lost from 15 frames after, pan MAE < 3e-3 rad after.
   (d) ``python3 -m ptzjax_torch.run --synthetic --frames 30`` in a
   subprocess with no ``--device``: it runs on ``cuda`` and exits 0. (e)
   ``--tracker homography --synthetic-images`` at 720p, 96 frames, bench.py's
   trajectory flags: no frame rejected, pan MAE over the first 20 frames <
   5e-3 rad (tests/test_baselines.py's bar), launches A 96, F 96 (the staged
   features), C 95 (one match a tracked frame), B, D and E 0; the first 8 frames on
   the card against the same CLI with ``--device cpu``; then
   ``track_homography_ekf`` over frames 1-40 of 4b's sequence on the graph
   route (one graph replayed a frame) and the eager route: bitwise, and
   wall, device time, kernels and busy share a frame. (f) ``--offline`` on
   5a's sequence (720p, 192 frames: at 96 the keyframe policy inserts none,
   and BA would refine rays against the one frozen bootstrap camera): no
   lost frame, pan MAE < 3e-3 rad, the BA cost not raised, launches A and F
   192 (the sharded frontend), B 0 and C and D the call sites' counts for its
   records. (g) ``dist.run_sharded`` in a one-rank
   NCCL process group on the card (TCP rendezvous on localhost): through
   the one-device mesh and through a mesh that holds the group (so the
   all-reduces and the all-gather run on NCCL), plain and robust, bitwise
   ``ba.run`` / ``ba.run_robust`` without a group, on the BA bench problem.
   (h) ``ptzjax_torch.soak.main`` at its defaults: 10,080 continuous 720p
   frames of its periodic 720-frame stack through ``run_segment_pixels``
   (the graph route) at the SLAMConfig defaults: the reference's four
   criteria (no silent drift, lost <= 1%, last-quartile fps > 0.9x the
   first's, peak map occupancy within capacity), at least one keyframe
   eviction at the cap of 64, the resume from the 2,400-frame checkpoint
   bitwise for one stack, the requested and reserved memory flat after
   the first chunk, the
   final whole-map BA not raising the cost, and the launches equal to the
   call sites' for ``init`` and the 10,080 frames; fps overall and by
   quartile, pan MAE by quartile, occupancy, memory readings and seconds.

The line before the last is one JSON object with the kernels' numbers
(``launches`` from run 4b, and for kernel E's two launches (``lk_track``,
``build_pyramid``), which only KLT mode runs, from 4e; kernel B, on no main path since kernels E and F took its call sites,
reads 0; ``launches_by_path`` from 4b, both 4c runs, 4e and the runs of
5a-5c and 5e-5h); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
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
    """(name, microseconds) of each device record of a closed profiler
    session, read from the profiler's raw records: building its event tree
    (``prof.events()``) takes seconds for the ~40,000 records of 40
    frames."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    return [(e.name(), e.duration_ns() / 1e3) for e in events if e.device_type() == DeviceType.CUDA]


def device_time(fn, batch: int = 50, per_call: int | None = None, tries: int = 4) -> tuple[float, dict]:
    """(device ms per call, {kernel name: count}) from the profiler's CUDA
    kernel records over ``batch`` calls after a warm-up. The profiler may
    lose records but never adds any, so a short session is profiled again:
    the answer is the first session with ``per_call * batch`` records or,
    where ``per_call`` is not known, with as many as some session before it
    (a stage's count can also drift over its first calls: 5 BA solves read
    23,520 records twice, then 23,509 three times), and failing that the
    fullest session, said so. More records than ``per_call * batch``, or
    never ``per_call * batch``, fail."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    seen: set = set()
    fullest = (-1, None, None)
    for attempt in range(tries):
        with profiled() as prof:
            for _ in range(batch):
                fn()
        kernels = device_kernels(prof)
        names: dict = {}
        for name, _ in kernels:
            names[name] = names.get(name, 0) + 1
        n = len(kernels)
        if per_call is not None:
            check(n <= per_call * batch, f"{len(names)} kernel names, {n / batch} kernels per call: {names}")
            done = n == per_call * batch
        else:
            done = n > 0 and n in seen
        total_us = sum(us for _, us in kernels)
        if done:
            return total_us / batch / 1e3, names
        if seen or per_call is not None:
            print(f"profiler: {n} kernel records from {batch} calls (session {attempt + 1}); profiling again")
        seen.add(n)
        fullest = max(fullest, (n, total_us, names), key=lambda f: f[0])
    n, total_us, names = fullest
    check(per_call is None and n > 0, f"no profiler session of {batch} calls had all its records (counts {sorted(seen)})")
    print(f"profiler: no two sessions agreed (counts {sorted(seen)}); the fullest, {n} records, is used")
    return total_us / batch / 1e3, names


def repeat_until_same(trace, count, tries: int = 2):
    """``trace()`` again until ``count`` of its result (a tuple of the
    profiler's record counts) repeats that of an earlier run, and failing
    that the fullest run, said so: the profiler may drop records, and a run
    with dropped ones under-reports kernels and device time."""
    seen: dict = {}
    for attempt in range(tries):
        out = trace()
        key = count(out)
        if key in seen:
            return out
        if seen:
            print(f"profiler: record counts {key} (pass {attempt + 1}); tracing again")
        seen[key] = out
    key = max(seen, key=sum)
    print(f"profiler: no two traced passes agreed (counts {list(seen)}); the fullest, {key}, is used")
    return seen[key]


def timings(fn, plain, nbytes: float, ops: float, library=None, plain_batch: int = 50) -> dict:
    """Event and device times of the kernel ``fn`` (one kernel a call, which
    ``device_time`` checks), its plain version (over ``plain_batch`` calls a
    timing), and the one-call library equivalent where there is one, with
    the bound."""
    dev_ms, names = device_time(fn, per_call=1)
    check(len(names) == 1, f"{len(names)} kernel names in one kernel a call: {names}")
    b_ms, b_by = bound(nbytes, ops)
    out = {
        "ms": time_ms(fn), "device_ms": dev_ms, "plain_ms": time_ms(plain, batch=plain_batch),
        "plain_device_ms": device_time(plain, batch=plain_batch)[0], "bound_ms": b_ms, "bound_by": b_by,
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
    from ptzjax_torch.kernels import flow as fl
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

    # B, which the plain routes still launch: 512 windows at win 46 and 18
    # (descriptors, with and without a scale), and at the LK shapes: the
    # template windows (side 16) and the search windows (side 24) at level
    # 0, the search windows at the 90 x 160 level; bitwise
    rng = np.random.default_rng(0)
    starts = {}
    for win in (SCALED_WIN, PATCH + 2):
        xy = np.stack([rng.uniform(0, w - 1, 512), rng.uniform(0, h - 1, 512)], -1)
        xy_d = torch.from_numpy(xy.astype(np.float32)).to(img.device)
        starts[f"win={win}"] = _window_starts(img, xy_d, win)[:3] + (win,)
    cfg = SLAMConfig()
    lk_xy = torch.from_numpy(lk_bench_inputs()[2]).to(img.device)
    side_t, side_s = cfg.flow_patch + 3, cfg.flow_patch + 2 * fl._DISP + 1
    anchor = fl._DISP + cfg.flow_patch // 2
    coarse = fl.build_pyramid(img, cfg.flow_levels)[-1]
    starts[f"lk side {side_t}, 720x1280"] = fl._patch_starts(img, lk_xy, side_t - 1)[:3] + (side_t - 1,)
    starts[f"lk side {side_s}, 720x1280"] = fl._search_starts(img, lk_xy, side_s, anchor) + (side_s - 1,)
    starts[f"lk side {side_s}, {coarse.shape[0]}x{coarse.shape[1]}"] = fl._search_starts(
        coarse, lk_xy / 2 ** (cfg.flow_levels - 1), side_s, anchor
    ) + (side_s - 1,)
    gather = {}
    for name, (pimg, ys, xs, win) in starts.items():
        out_k = wg.gather_windows(pimg, ys, xs, win)
        out_p = wg.gather_windows_plain(pimg, ys, xs, win)
        torch.cuda.synchronize()
        check(tuple(out_k.shape) == (512, win + 1, win + 1), f"gather shape {tuple(out_k.shape)}")
        check(torch.equal(out_k, out_p), f"gather_windows {name} is not bitwise equal")
        # the pixels the windows cover, each read once, the windows written
        # once, and the starts read
        side = win + 1
        hp, wp = pimg.shape
        r = torch.arange(side, device=img.device)
        yy = ys.long().clamp(0, hp - side)[:, None] + r
        xx = xs.long().clamp(0, wp - side)[:, None] + r
        covered = torch.unique((yy[:, :, None] * wp + xx[:, None, :]).reshape(-1)).numel()
        gather[name] = timings(
            lambda: wg.gather_windows(pimg, ys, xs, win),
            lambda: wg.gather_windows_plain(pimg, ys, xs, win),
            4 * (covered + out_k.numel() + 2 * ys.numel()), 0,
        )
        gather[name]["max_abs_err"] = float((out_k - out_p).abs().max())
        print(f"gather_windows K=512 {name} (window side {side}): bitwise equal; {describe(gather[name])} [{card}]")
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
            "note": "on no main path: kernels E and F took its call sites; the plain routes still gather through it",
            **gather[f"win={SCALED_WIN}"],
            "max_abs_err": max(v["max_abs_err"] for v in gather.values()),
            "ms_by_shape": gather,
        },
    ]


def run_slice(imgs: torch.Tensor, cams, intr, reloc_mode: str = "map", slam=None):
    """``PTZSlam.init`` on frame 0, then ``run_segment_pixels`` on the rest,
    at the product defaults (descriptor_f_ref AUTO), on the device of
    ``imgs``; through ``slam`` where it is given (a later pass on it
    replays the graphs an earlier one captured)."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    if slam is None:
        slam = PTZSlam(SLAMConfig(reloc_mode=reloc_mode), intr, device=imgs.device)
    state = slam.init(*extract_features(imgs[0], slam.cfg), cams[0])
    return slam.run_segment_pixels(state, imgs[1:])


def run_klt(imgs: torch.Tensor, cams, intr):
    """KLT mode: ``PTZSlam.init`` on frame 0, then ``run_segment_pixels_klt``
    on the rest, its carry seeded with frame 0 and its features, at the
    product defaults, on the device of ``imgs``."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    slam = PTZSlam(SLAMConfig(), intr, device=imgs.device)
    xy0, desc0, valid0 = extract_features(imgs[0], slam.cfg)
    state = slam.init(xy0, desc0, valid0, cams[0])
    state, infos, _, _ = slam.run_segment_pixels_klt(state, imgs[1:], imgs[0], xy0, valid0)
    return state, infos


def lk_bench_inputs():
    """``benchmarks/bench_suite.py``'s LK pair (``bench_flow``): a 720p pair
    of panorama seed 0 at cam0 = (0.05, -0.05, 2200) and cam0 + (0.005,
    -0.002, 4), and 512 keypoints from ``default_rng(0)``."""
    from ptzjax_torch import synth
    from ptzjax_torch.geometry import Intrinsics

    pano = synth.make_panorama(seed=0)
    intr = Intrinsics.create(640.0, 360.0)
    cam0 = np.array([0.05, -0.05, 2200.0], np.float32)
    cam1 = cam0 + np.array([0.005, -0.002, 4.0], np.float32)
    img0 = synth.render_image(pano, cam0, intr, 1280, 720)
    img1 = synth.render_image(pano, cam1, intr, 1280, 720)
    rng = np.random.default_rng(0)
    xy = np.stack([rng.uniform(20, 1260, 512), rng.uniform(20, 700, 512)], -1).astype(np.float32)
    return img0, img1, xy, np.ones(512, bool)


LK_OPTS = dict(patch=13, iters=8, min_eig=1e-3, max_residual=0.5, fb_check=True, fb_tol=1.0, border=2.0)


def _window_pixels(img: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor, side: int) -> torch.Tensor:
    """Flat indices of the pixels of ``img`` that side x side windows at
    image (top, left), rows and columns clamped into the image, cover."""
    h, w = img.shape
    r = torch.arange(side, device=img.device)
    rows = (tops.long()[:, None] + r).clamp(0, h - 1)
    cols = (lefts.long()[:, None] + r).clamp(0, w - 1)
    return (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)


def lk_work(prev_pyr, next_pyr, xy, valid, patch, iters, min_eig, max_residual, fb_check, border, **_) -> tuple[int, int]:
    """(bytes, fp32 operations) that kernel E needs for these inputs. Bytes:
    the pixels its windows cover in each level of each frame, each read
    once (the windows follow this run's guesses, which the plain route's
    own steps give), 9 B of position and flag read and 13 B of results
    written a keypoint. Operations, for each pass E makes over a keypoint
    (every level for a finite position, the backward check where the
    forward tests passed): the template blend, (patch + 2)^2 x 11 (two
    products a tap, three sums), the gradients, G and the std, patch^2 x
    14, 12 a sample and Newton step (the 4-tap sample's 4 products and 3
    sums, the difference, 2 products and 2 sums into b) and 10 a sample
    for the residual."""
    from ptzjax_torch.kernels import flow as fl

    levels = len(prev_pyr)
    finite = torch.isfinite(xy).all(-1)
    xs = xy[finite]
    pixels: dict = {}
    guess = xs / 2.0 ** (levels - 1)
    side_s, anchor = patch + 2 * fl._DISP + 1, fl._DISP + patch // 2
    pad_t = (patch + 2) // 2 + 1
    coarse = max(3, iters // 2)
    steps = 0
    for lvl in range(levels - 1, -1, -1):
        at = xs / 2.0**lvl
        _, ys_t, xs_t, _, _ = fl._patch_starts(prev_pyr[lvl], at, patch + 2)
        pixels.setdefault(("prev", lvl), []).append(_window_pixels(prev_pyr[lvl], ys_t - pad_t, xs_t - pad_t, patch + 3))
        _, ys_s, xs_s = fl._search_starts(next_pyr[lvl], guess, side_s, anchor)
        pixels.setdefault(("next", lvl), []).append(_window_pixels(next_pyr[lvl], ys_s - side_s, xs_s - side_s, side_s))
        n_it = iters if lvl == 0 else coarse
        guess, eig, resid = fl._lk_level(prev_pyr[lvl], next_pyr[lvl], at, guess, patch, n_it)
        steps += n_it
        if lvl > 0:
            guess = guess * 2.0
    passes = levels * int(finite.sum())
    h, w = next_pyr[0].shape
    ok = (
        valid[finite] & (eig > min_eig) & (resid < max_residual) & (guess[:, 0] >= border)
        & (guess[:, 0] <= w - 1 - border) & (guess[:, 1] >= border) & (guess[:, 1] <= h - 1 - border)
        & torch.isfinite(guess).all(-1)
    )
    n_fb = int(ok.sum()) if fb_check else 0
    if n_fb:
        _, ys_t, xs_t, _, _ = fl._patch_starts(next_pyr[0], guess[ok], patch + 2)
        pixels[("next", 0)].append(_window_pixels(next_pyr[0], ys_t - pad_t, xs_t - pad_t, patch + 3))
        _, ys_s, xs_s = fl._search_starts(prev_pyr[0], xs[ok], side_s, anchor)
        pixels[("prev", 0)].append(_window_pixels(prev_pyr[0], ys_s - side_s, xs_s - side_s, side_s))
    covered = sum(torch.unique(torch.cat(v)).numel() for v in pixels.values())
    nbytes = 4 * covered + 22 * xy.shape[0]
    per_pass = (patch + 2) ** 2 * 11 + patch**2 * 14
    ops = (
        int(finite.sum()) * (levels * per_pass + patch**2 * (12 * steps + 10 * levels))
        + n_fb * (per_pass + patch**2 * (12 * iters + 10))
    )
    return nbytes, ops


def pyramid_work(h: int, w: int, levels: int, frames: int) -> tuple[int, int]:
    """(bytes, fp32 operations) that kernel E's pyramid launch needs for
    ``frames`` (h, w) frames at ``levels`` levels. Bytes: level 0 read once
    and levels 1..levels-1 written once, 4 B a pixel. Operations, for each
    level built from the one below (h_l x w_l to h_l+1 x w_l+1): the
    vertical blur at the 2 h_l+1 rows the pool reads and every column, 9 a
    value (5 products, 4 sums), the horizontal blur at the 2 h_l+1 x 2
    w_l+1 pooled pixels, 9 each, and the pool, 4 an output."""
    sizes = [(h >> lvl, w >> lvl) for lvl in range(levels)]
    nbytes = 4 * (h * w + sum(a * b for a, b in sizes[1:]))
    ops = sum(
        9 * 2 * hn * wl + 9 * 4 * hn * wn + 4 * hn * wn
        for (_, wl), (hn, wn) in zip(sizes, sizes[1:])
    )
    return frames * nbytes, frames * ops


def lk_stage(dev, card) -> list[dict]:
    """3e: ``lk_track`` at the LK bench shape (4 levels, the backward check)
    through kernel E, one pyramid launch, one LK launch and no window
    gather a call, against the plain route on the card and the same code on
    the CPU: ``tracked`` equal, ``xy`` within 1e-3 px on tracked rows and
    the input position on the others; the pyramid launch's levels bitwise
    the plain pyramids'. Then E's two launches alone beside their plain
    versions (event and device time, bound, share), and the whole call's
    device time, kernels a call (the two launches, no torch kernel) and
    event time. Returns the LK launch's and the pyramid launch's numbers."""
    from ptzjax_torch.kernels import flow as fl
    from ptzjax_torch.kernels import window_gather as wg

    inputs = lk_bench_inputs()
    on_card = [torch.from_numpy(a).to(dev) for a in inputs]
    g0, e0, p0 = wg.launches, fl.launches, fl.pyramid_launches
    got = fl.lk_track(*on_card)
    gathers, kernel_e, pyramids = wg.launches - g0, fl.launches - e0, fl.pyramid_launches - p0
    plain = fl.lk_track(*on_card, plain=True)
    ref = fl.lk_track(*(torch.from_numpy(a) for a in inputs))
    torch.cuda.synchronize()
    check(
        (kernel_e, pyramids, gathers) == (1, 1, 0),
        f"lk_track: {kernel_e} LK launches of E, {pyramids} pyramid launches and {gathers} of B a call; 1, 1 and 0 expected",
    )
    tracked = plain.tracked
    check(torch.equal(got.tracked, tracked), "lk_track: tracked differs between kernel E and the plain route")
    err = float((got.xy[tracked] - plain.xy[tracked]).abs().max())
    check(err < 1e-3, f"lk_track: E's xy differs from the plain route by {err} px on tracked rows (tolerance 1e-3)")
    check(torch.equal(got.xy[~tracked], on_card[2][~tracked]), "lk_track: an untracked row left its input position")
    res_err = float((got.residual[tracked] - plain.residual[tracked]).abs().max())
    check(torch.equal(got.tracked.cpu(), ref.tracked), "lk_track: tracked differs between the card and the CPU")
    err_cpu = float((got.xy.cpu()[ref.tracked] - ref.xy[ref.tracked]).abs().max())
    check(err_cpu < 1e-3, f"lk_track: xy differs from the CPU by {err_cpu} px on tracked rows (tolerance 1e-3)")
    check(int(tracked.sum()) > 400, f"lk_track: only {int(tracked.sum())} of 512 tracked")

    xy, valid = on_card[2], on_card[3]
    prev_pyr, next_pyr = fl.build_pyramids([on_card[0], on_card[1]], 4)
    plain_pyrs = [fl.build_pyramid_plain(img, 4) for img in on_card[:2]]
    torch.cuda.synchronize()
    for got_p, want_p in zip((prev_pyr, next_pyr), plain_pyrs):
        check(
            all(torch.equal(a, b) for a, b in zip(got_p, want_p)),
            "build_pyramids: a level differs from the plain pyramid's (bitwise expected)",
        )
    h, w = on_card[0].shape
    p_bytes, p_ops = pyramid_work(h, w, 4, 2)
    tp = timings(
        lambda: fl.build_pyramids([on_card[0], on_card[1]], 4),
        lambda: [fl.build_pyramid_plain(img, 4) for img in on_card[:2]],
        p_bytes, p_ops, plain_batch=10,
    )
    tp["max_abs_err"] = 0.0
    nbytes, ops = lk_work(prev_pyr, next_pyr, xy, valid, **LK_OPTS)
    t = timings(
        lambda: fl.lk_pyramids(prev_pyr, next_pyr, xy, valid, **LK_OPTS),
        lambda: fl.lk_pyramids_plain(prev_pyr, next_pyr, xy, valid, **LK_OPTS),
        nbytes, ops, plain_batch=10,
    )
    t["max_abs_err"] = err

    def call():
        return fl.lk_track(*on_card)

    dev_ms, names = device_time(call, batch=20)
    per_call = sum(names.values()) / 20
    check(per_call == 2, f"lk_track: {per_call:g} kernels a call, 2 expected (E's two launches): {names}")
    print(
        f"lk_track 512 kp 720x1280, 4 levels + backward check: {int(tracked.sum())}/512 tracked; kernel E "
        f"{kernel_e} LK launch, {pyramids} pyramid launch and {gathers} window gathers a call; against the plain "
        f"route on the card tracked equal, xy max_abs_err {err} px, residual max_abs_err {res_err} (tracked rows); "
        f"against the CPU tracked equal, xy max_abs_err {err_cpu} px (tolerance 1e-3) [{card}]"
    )
    print(
        f"kernel E's pyramid launch (build_pyramids) 720x1280 pair, 4 levels, {p_bytes} B, {p_ops} flop: levels "
        f"bitwise the plain pyramids'; {describe(tp)} [{card}]"
    )
    print(f"kernel E's LK launch (lk_pyramids) 512 kp, 4 levels + backward check, {nbytes} B, {ops} flop: {describe(t)} [{card}]")
    print(
        f"lk_track stage 512 kp 720x1280: {dev_ms:.4f} ms device, {per_call:g} kernels a call, "
        f"{time_ms(call, reps=3, batch=20):.4f} ms event [{card}]"
    )
    return [
        {
            "name": "lk_track", "route": "cuda", "source": "ptzjax_torch/csrc/lk_flow.cu",
            "replaces": "ptzjax/kernels/window_pallas.py:67", **t,
        },
        {
            "name": "build_pyramid", "route": "cuda", "source": "ptzjax_torch/csrc/lk_flow.cu",
            "replaces": "ptzjax/kernels/flow.py:72", **tp,
            "note": "the pyramids of lk_track (XLA code beside the TPU kernel in the reference's jitted lk_track)",
        },
    ]


def sync_sites(fn) -> list[str]:
    """The lines of ``ptzjax_torch`` at which ``fn()`` made the host wait for
    the card (sync debug mode "warn"), the innermost frame of the package
    for each wait."""
    import traceback
    import warnings

    sites: list[str] = []

    def hook(message, *_args, **_kw):
        if "called a synchronizing" in str(message):   # not the prototype notice
            ours = [f for f in traceback.extract_stack() if f"{os.sep}ptzjax_torch{os.sep}" in f.filename]
            sites.append(f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}" if ours else "outside the package")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def describe_reads(h: int, w: int, xy: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The image pixels each row's descriptor depends on: (flat indices (K,
    n) of the (h, w) image, blended-sample mask of the aligned window). The
    gradients read every aligned sample of the 18 x 18 grid but its 4
    corners; with a scale, a sample reads the blended window at the
    resample's nonzero taps (at this run's clamped scale); a blended sample
    reads its 2 x 2 window pixels. Kernel F loads these rows and columns of
    each window; the plain route's dense product reads the whole window."""
    from ptzjax_torch.kernels import descriptor as kd

    side = kd.PATCH + 2
    grid = torch.ones(side, side)
    grid[0, 0] = grid[0, -1] = grid[-1, 0] = grid[-1, -1] = 0.0
    if scale is None:
        win, blended = side, grid > 0
    else:
        win = kd.SCALED_WIN
        s = torch.as_tensor(scale, dtype=torch.float32).cpu().clamp(1.0 / kd.MAX_SCALE, kd.MAX_SCALE)
        taps = (kd._resample_matrix(s, side, win) != 0).to(torch.float32)     # (18, 46)
        blended = taps.T @ grid @ taps > 0
    raw = torch.zeros(win + 1, win + 1, dtype=torch.bool)
    for dy in (0, 1):
        for dx in (0, 1):
            raw[dy : dy + win, dx : dx + win] |= blended
    rows, cols = kd._window_pixels(h, w, xy, win)
    return (rows[:, :, None] * w + cols[:, None, :])[:, raw.to(rows.device)], blended


def describe_work(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor, scale) -> tuple[int, int]:
    """(bytes, fp32 operations) that kernel F needs for these inputs, counted
    from the samples the descriptor depends on (``describe_reads``). Bytes:
    those pixels of the valid rows, each image pixel once, the scale, 9 B of
    position and flag read and 512 B of descriptor written a keypoint (the
    spatial weights are constants of the function). Operations, a valid keypoint: 11
    a needed blended sample; with a scale, 3 a tap pair of the separable
    resample (18 a needed blended row, then the 18 x 18 grid); 16 a patch
    pixel for its gradient, magnitude, orientation and bins; the histogram's
    nonzero terms (each pixel's nonzero spatial weights x its 2 orientation
    bins), 3 each, and 4 a pixel for its orientation weights; 10 a bin for
    the normalization."""
    from ptzjax_torch.kernels import descriptor as kd

    side, pix = kd.PATCH + 2, kd.PATCH * kd.PATCH
    h, w = img.shape
    pixels, blended = describe_reads(h, w, xy[valid], scale)
    resample = 0 if scale is None else (int(blended.any(1).sum()) * side + side * side) * 3
    covered = torch.unique(pixels.reshape(-1)).numel()
    num, n_valid = xy.shape[0], int(valid.sum())
    nonzero = int((kd._spatial_weights(img.device) != 0).sum())
    nbytes = 4 * covered + (0 if scale is None else 4) + num * (9 + 4 * kd.DESC_DIM)
    per_kp = 11 * int(blended.sum()) + resample + 16 * pix + 3 * 2 * nonzero + 4 * pix + 10 * kd.DESC_DIM
    return nbytes, n_valid * per_kp


def describe_stage(imgs: torch.Tensor, cams, intr, card: str) -> dict:
    """3f: ``describe_keypoints`` on frame 1 of the sequence at its 512
    detected keypoints, the last 4 rows made invalid (one of them NaN),
    through kernel F (one launch and no window gather a call) against the
    plain route on the card (B's windows and torch), at 4b's frame-1 scale
    (the bootstrap's live focal over f_ref, as the loop forms it), both
    clamp ends, 1.0, 1.37 and None: within 1e-5 a component, zeros on the
    invalid rows, three calls bitwise equal. Then F alone beside the plain
    route (event and device time, bound, share) for both routes, and the
    whole call's device time, kernels a call and event time through F and
    through the plain route. Returns F's numbers (the scaled route at 4b's
    frame-1 scale)."""
    from ptzjax_torch import slam as slam_mod
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import _desc_scale, extract_features
    from ptzjax_torch.kernels import descriptor as kd
    from ptzjax_torch.kernels import window_gather as wg
    from ptzjax_torch.kernels.detect import detect_keypoints

    dev = imgs.device
    slam = slam_mod.PTZSlam(SLAMConfig(), intr, device=dev)
    state = slam.init(*extract_features(imgs[0], slam.cfg), cams[0])
    s_4b = _desc_scale(slam.cfg, slam_mod._safe_focal(state, slam.cfg))
    img = imgs[1]
    kp = detect_keypoints(img, slam.cfg.max_keypoints, threshold=slam.cfg.detector_threshold)
    xy, valid = kp.xy.clone(), kp.valid.clone()
    valid[-4:] = False
    xy[-1] = float("nan")
    check(int(valid.sum()) == xy.shape[0] - 4, f"3f: {int(kp.valid.sum())} of 512 keypoints detected")
    scales = {
        "4b frame 1": s_4b, "1/2.5": torch.tensor(0.4, device=dev), "1.0": torch.tensor(1.0, device=dev),
        "1.37": torch.tensor(1.37, device=dev), "2.5": torch.tensor(2.5, device=dev), "None": None,
    }
    errs = {}
    for name, s in scales.items():
        f0, b0 = kd.launches, wg.launches
        got = kd.describe_keypoints(img, xy, valid, scale=s)
        launched = (kd.launches - f0, wg.launches - b0)
        ref = kd.describe_keypoints(img, xy, valid, scale=s, plain=True)
        again = [kd.describe_keypoints(img, xy, valid, scale=s) for _ in range(2)]
        torch.cuda.synchronize()
        check(launched == (1, 0), f"3f scale {name}: {launched[0]} launches of F and {launched[1]} of B a call, 1 and 0 expected")
        check(tuple(got.shape) == (512, kd.DESC_DIM) and bool(torch.isfinite(got).all()), f"3f scale {name}: shape or non-finite")
        err = float((got - ref).abs().max())
        check(err <= 1e-5, f"3f scale {name}: F differs from the plain route by {err} (tolerance 1e-5)")
        check(not bool(got[~valid].any()), f"3f scale {name}: an invalid row is not zero")
        check(all(torch.equal(a, got) for a in again), f"3f scale {name}: repeated calls differ")
        errs[name] = err
    print(
        "describe_keypoints 512 kp (4 invalid) on frame 1, 720x1280, kernel F against the plain route on the card, "
        "max_abs_err by scale (tolerance 1e-5): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (4b frame-1 scale {float(s_4b)}); invalid rows zero; three calls bitwise equal; 1 launch of F and "
        f"0 of B a call [{card}]"
    )
    # a non-finite pixel at row 0's keypoint: that row all NaN on both
    # routes; every other row F's within 1e-5 where the plain route's is
    # finite. Where the pixel lies in a row's 47-wide window but outside the
    # pixels F reads for it, the plain route's dense product (0 x inf) makes
    # that row NaN and F's stays finite
    h, w = img.shape
    spot = (int(xy[0, 1]), int(xy[0, 0]))
    bad = img.clone()
    bad[spot] = float("nan")
    nan_rows = {}
    for name in ("4b frame 1", "1/2.5", "2.5", "None"):
        s = scales[name]
        got = kd.describe_keypoints(bad, xy, valid, scale=s)
        ref = kd.describe_keypoints(bad, xy, valid, scale=s, plain=True)
        again = kd.describe_keypoints(bad, xy, valid, scale=s)
        torch.cuda.synchronize()
        check(bool(torch.isnan(got[0]).all() and torch.isnan(ref[0]).all()), f"3f NaN pixel, scale {name}: row 0 not all NaN")
        fin = torch.isfinite(ref).all(1)
        err = float((got[fin] - ref[fin]).abs().max())
        check(err <= 1e-5, f"3f NaN pixel, scale {name}: F differs from the plain route by {err} on finite rows")
        got_nan, ref_nan = torch.isnan(got).all(1), torch.isnan(ref).all(1)
        check(bool((got_nan <= ref_nan).all()) and bool((torch.isnan(got).any(1) == got_nan).all()), f"3f NaN pixel, scale {name}: NaN rows")
        reads, _ = describe_reads(h, w, xy, s)
        apart = ref_nan & ~got_nan
        check(not bool((reads[apart] == spot[0] * w + spot[1]).any()), f"3f NaN pixel, scale {name}: a finite F row reads the pixel")
        check(bool(torch.isfinite(got[apart]).all()), f"3f NaN pixel, scale {name}: a row apart is not finite")
        check(torch.equal(again.nan_to_num(7.0), got.nan_to_num(7.0)), f"3f NaN pixel, scale {name}: repeated calls differ")
        nan_rows[name] = (int(got_nan.sum()), int(ref_nan.sum()), err)
    print(
        f"describe_keypoints with a NaN pixel at row 0's keypoint {spot}: rows all NaN through F / the plain route, and "
        "max_abs_err on the plain route's finite rows, by scale: "
        + ", ".join(f"{k} {a} / {b}, {e:.3g}" for k, (a, b, e) in nan_rows.items())
        + f" (the rows apart read none of the pixel: F loads only what the taps read) [{card}]"
    )
    # no host read of the scale: a call waits for nothing; a tracked frame
    # (re-detect and KLT) waits only at the loop's designed reads
    waits = sync_sites(lambda: kd.describe_keypoints(img, xy, valid, scale=s_4b))
    check(not waits, f"3f: describe_keypoints waited for the card at {waits}")
    feats = extract_features(imgs[0], slam.cfg)
    frame_waits = {
        "re-detect": sync_sites(lambda: slam.run_segment_pixels(state, imgs[1:2])),
        "KLT": sync_sites(lambda: slam.run_segment_pixels_klt(state, imgs[1:2], imgs[0], feats[0], feats[2])),
    }
    for mode, w in frame_waits.items():
        check(not any("descriptor.py" in x or "frontend.py" in x for x in w), f"3f: a {mode} frame waited in the frontend at {w}")
    print(
        "sync debug mode: describe_keypoints waits for the card 0 times a call; frame 1 waits at "
        + "; ".join(f"{mode}: {sorted(set(w))} ({len(w)} waits)" for mode, w in frame_waits.items())
    )
    by_route, stage = {}, {}
    for route, s in (("scaled, 4b frame 1", s_4b), ("unscaled", None)):
        nbytes, ops = describe_work(img.cpu(), xy.cpu(), valid.cpu(), s)   # counted on the host
        t = timings(
            lambda: kd.describe_kernel(img, xy, valid, s),
            lambda: kd.describe_keypoints_plain(img, xy, valid, s),
            nbytes, ops, plain_batch=20,
        )
        t["max_abs_err"] = max(errs.values())
        by_route[route] = t
        print(f"kernel F (describe_kernel) 512 kp, {route}, {nbytes} B, {ops} flop: {describe(t)} [{card}]")
        for path, plain in (("F", False), ("plain route", True)):
            def call():
                return kd.describe_keypoints(img, xy, valid, scale=s, plain=plain)

            dev_ms, names = device_time(call, batch=20)
            stage[(route, path)] = (dev_ms, sum(names.values()) / 20, time_ms(call, reps=3, batch=20))
    for (route, path), (dev_ms, per_call, ev) in stage.items():
        print(
            f"describe_keypoints stage 512 kp 720x1280, {route}, through {path}: {dev_ms:.4f} ms device, "
            f"{per_call:g} kernels a call, {ev:.4f} ms event [{card}]"
        )
    return {
        "name": "describe_keypoints", "route": "cuda", "source": "ptzjax_torch/csrc/describe.cu",
        "replaces": "ptzjax/kernels/window_pallas.py:67", **by_route["scaled, 4b frame 1"],
        "ms_by_shape": by_route,
    }


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
        ("512x512 mutual", 512, 512, False, True, 0.8),
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


# each kernel's launch counter: (module of ptzjax_torch.kernels, attribute)
COUNTERS = {
    "harris_nms": ("harris_nms", "launches"), "gather_windows": ("window_gather", "launches"),
    "match_scores": ("match", "launches"), "cholesky": ("cholesky", "launches"),
    "lk_track": ("flow", "launches"), "build_pyramid": ("flow", "pyramid_launches"),
    "describe_keypoints": ("descriptor", "launches"),
}
COUNTER_NAMES = tuple(COUNTERS)


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(importlib.import_module(f"ptzjax_torch.kernels.{mod}"), attr, 0)
    importlib.import_module("ptzjax_torch.kernels.harris_nms").masked_launches = 0


def read_counts() -> dict:
    return {
        name: getattr(importlib.import_module(f"ptzjax_torch.kernels.{mod}"), attr)
        for name, (mod, attr) in COUNTERS.items()
    }


def expected_counts(infos, klt: bool = False) -> dict:
    """What the call sites launch in ``run_slice`` (or, with ``klt``, in
    ``run_klt``): detection and kernel F (the descriptors) on every frame
    (``init``'s included), the window gather never; in KLT mode kernel E's
    pyramid launch and its LK launch once each on every later frame (4
    levels: one pyramid launch); the matcher on every tracked frame, every keyframe insert
    (the bootstrap's included) and every relocalization frame; the Cholesky
    on every tracked frame."""
    return _expected(infos.event.cpu().numpy(), infos.keyframe.cpu().numpy(), klt)


def expected_from_records(records: list, klt: bool = False) -> dict:
    """``expected_counts`` for the CLI's per-frame records."""
    event = np.array([0 if r["event"] == "track" else 1 for r in records])
    return _expected(event, np.array([r["keyframe"] for r in records]), klt)


def _expected(event: np.ndarray, keyframe: np.ndarray, klt: bool) -> dict:
    tracked, relocs = int((event == 0).sum()), int((event == 1).sum())
    inserts = int(keyframe.sum())
    frames = len(event) + 1
    return {
        "harris_nms": frames, "gather_windows": 0,
        "match_scores": tracked + inserts + 1 + relocs, "cholesky": tracked,
        "lk_track": frames - 1 if klt else 0, "build_pyramid": frames - 1 if klt else 0,
        "describe_keypoints": frames,
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


INSERT_FRAME = 120    # the cadence insert (and its windowed BA) of 4b's sequence
INSERT_REPEATS = 10   # 4d runs it this many times from the same state


def captures(slam) -> list:
    """(graph kind, set-up s, pool growth bytes) of each frame graph a
    ``PTZSlam``'s graph route has captured: the captures of its four
    branches, the assembly and the instantiation, and the growth of their
    one pool."""
    if slam._graphs is None:
        return []
    return [
        (g.kind, g.program.capture_s, g.program.pool_bytes)
        for g in slam._graphs.graphs.values() if g.program.capture_s is not None
    ]


def describe_captures(caps) -> str:
    return ", ".join(f"{kind} frame graph {1e3 * s:.1f} ms +{b / 2**20:.0f} MiB" for kind, s, b in caps)


def frame_phase(imgs: torch.Tensor, cams, intr, card: str, measured=None):
    """4d: wall and device time and kernels per frame kind, in each reloc
    mode, through the graph route (the default) and the eager route
    (``_graphs=False``), the two routes' wall passes in turns: 40 tracked
    frames (40-79), the insert frame (INSERT_FRAME, run INSERT_REPEATS
    times from the state before it: the track branch, then the insert and
    the windowed BA) and the relocalization frames (141-147) of the 4c
    sequence. Each window's first frame runs once from the window's start
    state before the timed frames, which start from it again, so that the
    graph route's frame graph is captured before the clock. Frames run one
    per call with a sync after each; one pass times their wall clock, a
    second pass runs the profiler over them (its per-launch cost would
    swell a wall time). Then two passes of the graph route time each
    window in one call (the insert frame is a window of one), its wall
    divided by its frames: a call waits for the card once, so this is the
    frame's wall inside a segment. The frame graph's set-up (its captures,
    assembly and instantiation, pool growth) is printed apart.

    Called twice: without ``measured`` it runs the wall passes and returns
    them, before any profiler session (after one, a launch of a graph with
    conditional nodes makes the host wait for the card); with them it runs
    the profiled passes and prints every row."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    dark = imgs.clone()
    dark[BLACKOUT.start:BLACKOUT.stop] = 0.0
    # (kind, frames, event + 2 * keyframe)
    windows = (
        ("tracked", range(40, 80), 0),
        ("insert", range(INSERT_FRAME, INSERT_FRAME + 1), 2),
        ("reloc", range(BLACKOUT.start + 1, BLACKOUT.stop + 1), 1),
    )

    def run(mode: str, graphs: bool, traced: bool, one_call: bool = False, slam=None) -> dict:
        if slam is None:
            slam = PTZSlam(SLAMConfig(reloc_mode=mode), intr, _graphs=graphs)   # the card, by default
        state = slam.init(*extract_features(dark[0], slam.cfg), cams[0])
        at, out = 1, {}
        for kind, frames, event in windows:
            state, _ = slam.run_segment_pixels(state, dark[at:frames.start])
            slam.run_segment_pixels(state, dark[frames.start:frames.start + 1])   # the warm-up
            torch.cuda.synchronize()
            at = frames.stop
            reps = INSERT_REPEATS if kind == "insert" else 1
            spans = [(frames.start, frames.stop)] if one_call else [(f, f + 1) for f in frames]
            walls, events = [], []
            with profiled() if traced else contextlib.nullcontext() as prof:
                for a, b in spans:
                    before = state
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        state, info = slam.run_segment_pixels(before, dark[a:b])
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) / (b - a))
                        events += (info.event + 2 * info.keyframe.to(torch.int32)).tolist()
            check(all(e == event for e in events), f"4d {mode}: frames {frames} ran events {events}")
            if not traced:
                out[kind] = float(np.median(walls)) * 1e3
                continue
            kernels = device_kernels(prof)
            check(kernels, "the profiler recorded no device time")
            by_name: dict = {}
            for name, us in kernels:
                by_name[name] = by_name.get(name, 0.0) + us
            out[kind] = (
                sum(by_name.values()) / len(events) / 1e3, len(kernels) / len(events),
                sorted(by_name.items(), key=lambda kv: -kv[1])[:4],
            )
        if graphs and not traced:
            out["captures"] = captures(slam)
        out["slam"] = slam
        return out

    if measured is None:   # the wall passes: no profiler session may come before them
        measured = {}
        for mode in ("map", "keyframe"):
            walls: dict = {}
            for graphs in (True, False, False, True):
                walls.setdefault(graphs, []).append(run(mode, graphs, False))
            measured[mode] = walls, [run(mode, True, False, one_call=True) for _ in range(2)]
        return measured
    for mode in ("map", "keyframe"):
        (walls, one_call), traced = measured[mode], {}
        for graphs in (True, False):
            # on a PTZSlam of the wall passes, whose frame graph was made
            # before any profiler session: one made after it has its kernels
            # in conditional bodies traced with inflated times, or not at all
            slam = walls[graphs][0]["slam"]
            traced[graphs] = repeat_until_same(
                lambda: run(mode, graphs, True, slam=slam),
                lambda r: tuple(v[1] for k, v in r.items() if k != "slam"),
            )
        for w in walls[True]:
            print(
                f"4d reloc_mode={mode}, graph route: set-up (captures + assembly + instantiation, pool growth) "
                + describe_captures(w["captures"]) + f" (once a PTZSlam, in its first call) [{card}]"
            )
        for kind, frames, _ in windows:
            nf = len(frames) * (INSERT_REPEATS if kind == "insert" else 1)
            for graphs in (True, False):
                device_ms, per_frame, top = traced[graphs][kind]
                wall = float(np.median([w[kind] for w in walls[graphs]]))
                print(
                    f"4d {kind} frames {frames.start}-{frames.stop - 1}"
                    + (f" x{INSERT_REPEATS} from one state" if kind == "insert" else "")
                    + f", reloc_mode={mode}, {'graph' if graphs else 'eager'} route, one frame a call: wall median "
                    f"{wall:.3f} ms (passes {', '.join(f'{w[kind]:.3f}' for w in walls[graphs])}), device "
                    f"{device_ms:.4f} ms a frame ({per_frame:.1f} kernels, busy {100 * device_ms / wall:.1f}%); largest: "
                    + "; ".join(f"{name[:60]} {us / nf / 1e3:.4f} ms" for name, us in top)
                    + f" [{card}]"
                )
            device_ms = traced[True][kind][0]
            wall = float(np.median([w[kind] for w in one_call]))
            print(
                f"4d {kind} frames {frames.start}-{frames.stop - 1}"
                + (f" x{INSERT_REPEATS} from one state" if kind == "insert" else "")
                + f", reloc_mode={mode}, graph route, {len(frames)} frame(s) in one call: wall a frame {wall:.3f} ms "
                f"(passes {', '.join(f'{w[kind]:.3f}' for w in one_call)}), device {device_ms:.4f} ms a frame, busy "
                f"{100 * device_ms / wall:.1f}% [{card}]"
            )


TRACKED = range(40, 80)   # 4d's and 4h's tracked frames (no insert, no loss)


def staged_features(imgs: torch.Tensor, cams, frames: int):
    """The re-detect frontend's features of frames [0, ``frames``), staged
    on the card for features mode as ``--offline`` stages them: the
    descriptor scale anchored on frame 0's focal (which ``init`` makes
    ``descriptor_f_ref``). Made before any clock starts."""
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features

    f0 = float(cams[0][2])
    cfg = SLAMConfig(descriptor_f_ref=f0)
    out = [extract_features(imgs[k], cfg, focal=f0) for k in range(frames)]
    return tuple(torch.stack([f[i] for f in out]) for i in range(3))


class Loop:
    """One ``PTZSlam`` at the SLAMConfig defaults (``reloc_mode`` aside),
    bootstrapped by ``init`` on frame 0 and driven through a public entry
    point: ``run_segment_pixels`` ("re-detect"), ``run_segment_pixels_klt``
    ("KLT", the carry threaded from call to call: the chunk's last frame and
    the table it returned) or ``run_segment`` ("features", on
    ``staged_features``). ``graphs=False`` asks for the eager route (the
    default constructor otherwise, so that an older checkout runs it);
    ``slam`` reuses a ``PTZSlam`` (and its graphs) of an earlier loop."""

    def __init__(self, kind: str, imgs, cams, intr, *, mode="map", graphs=True, masks=None, feats=None, slam=None):
        from ptzjax_torch.config import SLAMConfig
        from ptzjax_torch.frontend import extract_features
        from ptzjax_torch.slam import PTZSlam

        cfg = SLAMConfig(reloc_mode=mode)
        if slam is None:
            slam = PTZSlam(cfg, intr) if graphs else PTZSlam(cfg, intr, _graphs=False)
        self.slam = slam
        self.kind, self.imgs, self.masks, self.feats = kind, imgs, masks, feats
        first = tuple(v[0] for v in feats) if kind == "features" else extract_features(imgs[0], self.slam.cfg)
        self.state = self.slam.init(*first, cams[0])
        self.carry = (imgs[0], first[0], first[2])
        self.at = 1

    def run(self, stop: int):
        """Frames [at, ``stop``) in one call: their stacked infos."""
        a, slam = self.at, self.slam
        masks = None if self.masks is None else self.masks[a:stop]
        if self.kind == "re-detect":
            self.state, infos = slam.run_segment_pixels(self.state, self.imgs[a:stop], masks)
        elif self.kind == "KLT":
            self.state, infos, xy, valid = slam.run_segment_pixels_klt(
                self.state, self.imgs[a:stop], *self.carry, masks=masks
            )
            self.carry = (self.imgs[stop - 1], xy, valid)
        else:
            self.state, infos = slam.run_segment(self.state, *(v[a:stop] for v in self.feats))
        self.at = stop
        return infos


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> bool:
    from ptzjax_torch.checkpoint import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


WINDOW = range(100, 161)   # 4h: the cadence insert at 120, the blackout 140-146, the recovery


def window_counts(infos: list, kind: str, masked: bool) -> dict:
    """What the call sites launch over one-frame calls' ``infos``: A and F
    a frame from pixels, E a KLT frame, C a tracked frame, an insert and a
    relocalization frame, D a tracked frame, B never; and A's masked
    launches."""
    event = np.array([int(i.event[0]) for i in infos])
    inserts = sum(int(i.keyframe[0]) for i in infos)
    frames, tracked, pixels = len(event), int((event == 0).sum()), kind != "features"
    return {
        "harris_nms": frames * pixels, "gather_windows": 0,
        "match_scores": tracked + inserts + int((event == 1).sum()), "cholesky": tracked,
        "lk_track": frames * (kind == "KLT"), "build_pyramid": frames * (kind == "KLT"),
        "describe_keypoints": frames * pixels, "masked": frames * masked,
    }


def graph_phase(imgs: torch.Tensor, cams, intr, card: str) -> None:
    """4h: the graph route against the eager route (``_graphs=False``) over
    WINDOW of the 4c sequence (the cadence insert at 120, the blackout
    140-146 and the recovery), one frame a call after frames 1-99 in one,
    in re-detect, KLT and features mode (``run_segment`` on
    ``staged_features``), in map mode, in keyframe mode and (re-detect,
    KLT) with a mask of three boxes on every frame. The graph route runs
    the window three times on one ``PTZSlam``, each from its kept state at
    99: twice one frame a call (the first pass's first call captures the
    frame graph), then the whole window in one call. On every pass every
    FrameInfo, the final state and the KLT carry are bitwise the eager
    route's and the launches the same, which are the call sites'; the host
    waits for the card (sync debug mode) once a call, in ``_graphs.py``,
    on every frame kind (counted from frame 101 on the second pass, whose
    calls all replay) and once for the one-call pass."""
    from ptzjax_torch.kernels import harris_nms
    from ptzjax_torch.slam import FrameInfo

    dark = imgs[:WINDOW.stop].clone()
    dark[BLACKOUT.start:BLACKOUT.stop] = 0.0
    boxes = torch.ones(imgs.shape[1:], dtype=torch.bool, device=imgs.device)
    for y0, y1, x0, x1 in ((100, 300, 200, 400), (450, 700, 900, 1200), (0, 120, 1100, 1280)):
        boxes[y0:y1, x0:x1] = False
    feats = staged_features(dark, cams, WINDOW.stop)
    cases = [(kind, mode, False) for kind in ("re-detect", "KLT", "features") for mode in ("map", "keyframe")]
    cases += [("re-detect", "map", True), ("KLT", "map", True)]
    for kind, mode, masked in cases:
        masks = boxes.expand(dark.shape) if masked else None
        passes = {True: [], False: []}
        for graphs in (True, False):
            loop = Loop(kind, dark, cams, intr, mode=mode, graphs=graphs, masks=masks, feats=feats)
            loop.run(WINDOW.start)
            kept = loop.state, loop.carry
            for one_call in ((False, False, True) if graphs else (False,)):
                loop.state, loop.carry, loop.at = *kept, WINDOW.start
                reset_counts()
                infos, waits = [], []
                if one_call:
                    waits.append(sync_sites(lambda: infos.append(loop.run(WINDOW.stop))))
                    infos = [FrameInfo(*(v[k:k + 1] for v in infos[0])) for k in range(len(WINDOW))]
                else:
                    for f in WINDOW:
                        waits.append(sync_sites(lambda: infos.append(loop.run(f + 1))))
                counts = {**read_counts(), "masked": harris_nms.masked_launches}
                passes[graphs].append((loop.state, infos, waits, counts, loop.carry[1:]))
            if graphs:
                capture = captures(loop.slam)
                taken = dict(next(iter(loop.slam._graphs.graphs.values())).counts)
        (s_e, i_e, w_e, n_e, c_e), = passes[False]
        what = f"4h {kind} reloc_mode={mode} masked={masked}"
        want = window_counts(i_e, kind, masked)
        check(n_e == want, f"{what}: eager launches {n_e}, call sites give {want}")
        for k, (s_g, i_g, w_g, n_g, c_g) in enumerate(passes[True]):
            differ = [f for f, a, b in zip(WINDOW, i_g, i_e) if not _same(a, b)]
            check(not differ, f"{what}, pass {k + 1}: frames {differ} differ between the graph and eager routes")
            check(_same(s_g, s_e), f"{what}, pass {k + 1}: the final states differ")
            check(all(torch.equal(a, b) for a, b in zip(c_g, c_e)), f"{what}, pass {k + 1}: the KLT carries differ")
            check(n_g == n_e, f"{what}, pass {k + 1}: launches {n_g} (graph) and {n_e} (eager)")
        kinds = [int(i.event[0]) + 2 * int(i.keyframe[0]) for i in i_e]
        check(
            kinds[INSERT_FRAME - WINDOW.start] == 2 and kinds.count(1) >= 2
            and any(bool(i.reloc_success[0]) for i in i_e),
            f"{what}: frame kinds {kinds} (want the insert at {INSERT_FRAME}, lost frames and a recovery)",
        )
        w_g, w_one = passes[True][1][2], passes[True][2][2]
        by_kind: dict = {}
        for f, e, w in zip(WINDOW, kinds, w_g):
            if f > WINDOW.start:
                by_kind.setdefault({0: "tracked", 1: "lost", 2: "insert"}[e], set()).add(len(w))
        check(
            all(len(w) == 1 and all("_graphs.py" in x for x in w) for f, w in zip(WINDOW, w_g) if f > WINDOW.start),
            f"{what}: graph-route waits a frame {[(f, w) for f, w in zip(WINDOW, w_g)][1:][:4]}",
        )
        check(len(w_one[0]) == 1 and "_graphs.py" in w_one[0][0], f"{what}: the one-call pass waited at {w_one}")
        branches = {"lost": 3 * kinds.count(1), "track": 3 * kinds.count(0) + 3 * kinds.count(2)}
        check(
            all(taken[b] >= n for b, n in branches.items()) and taken["insert+ba"] >= 3,
            f"{what}: the frame graph took {taken}",
        )
        print(
            f"4h graph route vs eager, {kind}, frames {WINDOW.start}-{WINDOW.stop - 1} (insert at {INSERT_FRAME}, "
            f"blackout {BLACKOUT.start}-{BLACKOUT.stop - 1}; kinds: {kinds.count(0)} tracked, {kinds.count(2)} insert, "
            f"{kinds.count(1)} lost), reloc_mode={mode}, mask {'3 boxes' if masked else 'none'}: FrameInfos, final "
            f"state{' and carry' if kind == 'KLT' else ''} bitwise equal on two one-frame-a-call graph passes and "
            f"one one-call pass; launches {n_e}, the call sites'; host waits a call on the second pass {by_kind}, "
            f"on the one-call pass {len(w_one[0])}, at {sorted(set(sum(w_g + w_one, [])))}, eager waits a frame "
            f"{sorted({len(w) for w in w_e})}; branches the frame graph took over the graph passes (and the "
            f"frames before) {taken}; set-up " + describe_captures(capture) + f" [{card}]"
        )


def frame_walls(imgs: torch.Tensor, cams, intr, card: str) -> str:
    """The wall medians of 4d's tracked frames 40-79 (map mode, no keyframe
    insert) in re-detect, KLT and features mode (features staged before the
    clock), the modes in turns, one frame a call with a sync after each.
    Uses only the public entry points, so the same code times an earlier
    checkout (``--frame-walls``)."""
    feats = staged_features(imgs, cams, TRACKED.stop)
    loops = {kind: Loop(kind, imgs, cams, intr, feats=feats) for kind in ("re-detect", "KLT", "features")}
    walls: dict = {kind: [] for kind in loops}
    for loop in loops.values():
        loop.run(TRACKED.start)
    for f in TRACKED:
        for kind, loop in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.run(f + 1)
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
    return f"frame walls, tracked frames {TRACKED.start}-{TRACKED.stop - 1}: " + ", ".join(
        f"{kind} median {np.median(w):.3f} ms" for kind, w in walls.items()
    ) + f" [{card}]"


def klt_phase(imgs: torch.Tensor, cams, intr, card: str):
    """4e: the whole sequence in KLT mode, counted; returns the launch
    counts."""
    from ptzjax_torch import eval as ev

    frames = imgs.shape[0]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, infos = run_klt(imgs, cams, intr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = expected_counts(infos, klt=True)
    print(f"launches over the {frames}-frame KLT path: {counts}")
    check(counts == want, f"KLT: launches {counts}, call sites give {want}")
    check(all(v > 0 for k, v in counts.items() if k != "gather_windows"), f"KLT: a kernel never launched: {counts}")
    pose = infos.pose.cpu().numpy()
    lost = infos.lost.cpu().numpy()
    check(pose.shape == (frames - 1, 3) and np.isfinite(pose).all(), "KLT: poses not finite / wrong shape")
    pan_mae = float(np.abs(pose[:, 0] - cams[1:, 0]).mean())
    report = ev.evaluate_run(infos, cams, intr, imgs.shape[2], imgs.shape[1])
    print(
        f"KLT: {frames} frames 720p at SLAMConfig defaults: lost {int(lost.sum())}, pan MAE {pan_mae} rad, "
        f"kf stored {int(state.kf.count)}; evaluate_run {json.dumps(report)}"
    )
    print(f"KLT wall clock: {wall:.3f} s, {frames / wall:.2f} frames/s [{card}]")
    check(not lost.any(), f"KLT: lost frames at {np.nonzero(lost)[0]}")
    check(pan_mae < 3e-3, f"KLT: pan MAE {pan_mae} >= 3e-3")
    check(int(infos.keyframe.sum()) >= 1 and int(state.kf.count) >= 2, "KLT: no keyframe insert ran windowed BA")
    return counts


def mode_frame_phase(imgs: torch.Tensor, cams, intr, card: str, kind: str, measured=None):
    """4d, KLT mode ("KLT") or features mode ("features": ``run_segment`` on
    ``staged_features``, made before the clock): the 40 tracked frames
    40-79 one a call with a sync after each, through the graph route (the
    default) and the eager route (``_graphs=False``): a wall pass of each
    in turns (graph, eager, eager, graph), the launches of every pass
    counted (each kernel of the mode once a frame), then, on the graph
    route, two passes of the 40 frames in one call (wall a frame), then a
    pass of each route under the profiler. Called twice, as
    ``frame_phase``: without ``measured`` it runs the wall passes (printing
    the launches and the frame graph's set-up) and returns them with the
    first graph pass's launch counts; with them it runs the profiled
    passes, on the wall passes' first ``PTZSlam`` of each route, and
    prints wall, device, kernels and busy share a frame."""
    feats = staged_features(imgs, cams, TRACKED.stop) if kind == "features" else None
    nf = len(TRACKED)

    def run(graphs: bool, traced: bool, one_call: bool = False, slam=None):
        loop = Loop(kind, imgs, cams, intr, graphs=graphs, feats=feats, slam=slam)
        loop.run(TRACKED.start)
        torch.cuda.synchronize()
        walls, events = [], []
        reset_counts()
        stops = [TRACKED.stop] if one_call else [f + 1 for f in TRACKED]
        with profiled() if traced else contextlib.nullcontext() as prof:
            for stop in stops:
                t0 = time.perf_counter()
                info = loop.run(stop)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) / len(info.event))
                events += (info.event + 2 * info.keyframe.to(torch.int32)).tolist()
        check(all(e == 0 for e in events), f"4d {kind}: frames {TRACKED} ran events {events}")
        return float(np.median(walls)) * 1e3, prof, read_counts(), loop.slam

    if measured is None:
        walls: dict = {True: [], False: []}
        counts, slams = {}, {}
        for graphs in (True, False, False, True):
            wall, _, c, slam = run(graphs, False)
            walls[graphs].append(wall)
            slams.setdefault(graphs, slam)
            counts.setdefault(graphs, []).append(c)
        one_call = [run(True, False, one_call=True)[0] for _ in range(2)]
        each = nf if kind == "KLT" else 0
        want = {
            **dict.fromkeys(COUNTER_NAMES, each), "gather_windows": 0, "match_scores": nf, "cholesky": nf,
        }
        print(f"4d {kind} tracked frames {TRACKED.start}-{TRACKED.stop - 1}: launches {counts[True][0]}")
        for graphs, cs in counts.items():
            check(all(c == want for c in cs), f"4d {kind} graphs={graphs}: launches {cs}, call sites give {want}")
        print(
            f"4d {kind}, graph route: set-up (captures + assembly + instantiation, pool growth) "
            + describe_captures(captures(slams[True])) + f" (once a PTZSlam, in its first call) [{card}]"
        )
        return (walls, one_call, slams), counts[True][0]
    walls, one_call, slams = measured
    for graphs in (True, False):
        kernels = repeat_until_same(
            lambda: device_kernels(run(graphs, True, slam=slams[graphs])[1]), lambda k: (len(k),)
        )
        check(kernels, "the profiler recorded no device time")
        by_name: dict = {}
        for name, us in kernels:
            by_name[name] = by_name.get(name, 0.0) + us
        device_ms = sum(by_name.values()) / nf / 1e3
        wall = float(np.median(walls[graphs]))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(
            f"4d {kind} tracked frames {TRACKED.start}-{TRACKED.stop - 1} (no keyframe insert), "
            f"{'graph' if graphs else 'eager'} route, one frame a call: wall median {wall:.3f} ms (passes "
            f"{', '.join(f'{w:.3f}' for w in walls[graphs])}), device {device_ms:.4f} ms a frame "
            f"({len(kernels) / nf:.1f} kernels, busy {100 * device_ms / wall:.1f}%); largest: "
            + "; ".join(f"{name[:60]} {us / nf / 1e3:.4f} ms" for name, us in top)
            + f" [{card}]"
        )
        if graphs:
            wall = float(np.median(one_call))
            print(
                f"4d {kind} tracked frames {TRACKED.start}-{TRACKED.stop - 1}, graph route, {nf} frames in one call: "
                f"wall a frame {wall:.3f} ms (passes {', '.join(f'{w:.3f}' for w in one_call)}), device "
                f"{device_ms:.4f} ms a frame, busy {100 * device_ms / wall:.1f}% [{card}]"
            )


def bench_ba_problem(dev, k: int = 32, m: int = 4096, c: int = 6, seed: int = 0):
    """``benchmarks/bench_suite.py:_make_ba_problem`` rebuilt in numpy with
    the port's geometry: k cameras on a pan/zoom sweep, m rays, c
    observations a ray with 0.5 px noise, cameras and rays perturbed, the
    first camera frozen. Returns (problem on ``dev``, intrinsics)."""
    from ptzjax_torch import ba
    from ptzjax_torch.geometry import Intrinsics, project_rays

    rng = np.random.default_rng(seed)
    intr = Intrinsics.create(640.0, 360.0)
    cams_gt = np.stack([np.linspace(0, 0.5, k), np.full(k, -0.06), np.linspace(2000, 2800, k)], -1).astype(np.float32)
    rays_gt = np.stack([rng.uniform(0, 0.5, m), rng.uniform(-0.2, 0.05, m)], -1).astype(np.float32)
    obs_cam = rng.integers(0, k, (m, c)).astype(np.int32)
    pix = project_rays(torch.from_numpy(cams_gt[obs_cam]), torch.from_numpy(rays_gt)[:, None, None, :].expand(m, c, 1, 2), intr)[:, :, 0]
    obs_pix = pix.numpy() + rng.normal(0, 0.5, (m, c, 2)).astype(np.float32)
    cams0 = cams_gt + rng.normal(0, 4e-3, (k, 3)).astype(np.float32) * np.array([1.0, 1.0, 2500.0], np.float32)
    rays0 = rays_gt + rng.normal(0, 2e-3, (m, 2)).astype(np.float32)
    arrays = (cams0, rays0, obs_pix, obs_cam, np.ones((m, c), np.float32), np.array([False] + [True] * (k - 1)))
    return ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)), intr


def scipy_ba_ms(prob, intr) -> tuple[float, float]:
    """fp64 ``scipy.optimize.least_squares`` (TRF, the block sparsity of
    ``benchmarks/bench_suite.py:205-227``, 25 evaluations) on the same
    problem on the host: (wall ms, final cost)."""
    import scipy.optimize
    import scipy.sparse

    cams0, rays0, obs_pix = (prob[i].cpu().numpy().astype(np.float64) for i in range(3))
    obs_cam = prob.obs_cam.cpu().numpy()
    k, (m, c) = cams0.shape[0], obs_cam.shape
    cx, cy = float(intr.cx), float(intr.cy)

    def residual(x):
        cams, rays = x[: 3 * k].reshape(k, 3), x[3 * k:].reshape(m, 2)
        cam = cams[obs_cam]
        u = rays[:, None, 0] - cam[..., 0]
        v = rays[:, None, 1] - cam[..., 1]
        px = cam[..., 2] * np.tan(u) + cx
        py = -cam[..., 2] * np.tan(v) / np.cos(u) + cy
        return (np.stack([px, py], -1) - obs_pix).reshape(-1)

    # each residual row touches its camera's 3 and its ray's 2 parameters
    rows = np.arange(m * c * 2).reshape(m, c, 2)
    cam_cols = obs_cam[:, :, None, None] * 3 + np.arange(3)
    ray_cols = 3 * k + np.arange(m)[:, None, None, None] * 2 + np.arange(2)
    r_c = np.broadcast_to(rows[..., None], (m, c, 2, 3))
    r_r = np.broadcast_to(rows[..., None], (m, c, 2, 2))
    spar = scipy.sparse.coo_matrix(
        (np.ones(r_c.size + r_r.size), (np.concatenate([r_c.ravel(), r_r.ravel()]),
         np.concatenate([np.broadcast_to(cam_cols, r_c.shape).ravel(), np.broadcast_to(ray_cols, r_r.shape).ravel()]))),
        shape=(m * c * 2, 3 * k + 2 * m),
    )
    x0 = np.concatenate([cams0.ravel(), rays0.ravel()])
    t0 = time.perf_counter()
    res = scipy.optimize.least_squares(residual, x0, jac_sparsity=spar, method="trf", max_nfev=25)
    return (time.perf_counter() - t0) * 1e3, float(2 * res.cost)


def ba_phase(state, intr, dev, card: str) -> None:
    """4f: whole-map BA (``PTZSlam.bundle_adjust``) on the 4b run's final
    state, plain and robust; then ``ba.run`` and ``ba.run_robust`` on the BA
    bench problem (32 cameras, 4,096 rays, 24,576 observations, 20 LM
    iterations) beside scipy's fp64 solver on the same problem."""
    from ptzjax_torch import ba
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.slam import PTZSlam

    for huber in (0.0, 2.0):
        slam = PTZSlam(SLAMConfig(ba_huber_px=huber), intr, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cost = slam.bundle_adjust(state)
        wall = (time.perf_counter() - t0) * 1e3
        before, after = cost["ba_cost_before"], cost["ba_cost_after"]
        check(np.isfinite(before) and np.isfinite(after) and after <= before, f"bundle_adjust huber {huber}: {cost}")
        print(
            f"bundle_adjust over the whole map ({int(state.kf.count)} keyframes), ba_huber_px={huber}: "
            f"cost {before:.3f} -> {after:.3f} px^2; wall {wall:.3f} ms [{card}]"
        )

    prob, bintr = bench_ba_problem(dev)
    nobs = int(prob.obs_w.sum())
    cfg = SLAMConfig(ba_iters=20)
    for name, fn in (
        ("ba.run", lambda: ba.run(prob, bintr, cfg)),
        ("ba.run_robust (2 IRLS rounds, huber 2 px)", lambda: ba.run_robust(prob, bintr, cfg.replace(ba_huber_px=2.0))),
    ):
        res = fn()
        c0, c1 = float(res.initial_cost), float(res.cost)
        check(np.isfinite(c1) and c1 < c0, f"{name}: cost {c0} -> {c1}")
        dev_ms, names = device_time(fn, batch=5)
        print(
            f"{name} {prob.cams.shape[0]} cams, {prob.rays.shape[0]} rays, {nobs} obs, 20 LM iterations: "
            f"cost {c0:.1f} -> {c1:.1f} px^2; {time_ms(fn, reps=3, batch=5):.3f} ms event, "
            f"{dev_ms:.3f} ms device ({sum(names.values()) / 5:g} kernels) [{card}]"
        )
    sp_ms, sp_cost = scipy_ba_ms(prob, bintr)
    print(f"scipy least_squares fp64 TRF (host CPU), same problem: {sp_ms:.1f} ms, final cost {sp_cost:.1f} px^2 [{card}]")


def resume_phase(imgs: torch.Tensor, cams, intr, infos_full, card: str) -> None:
    """4g: the 4b sequence to frame 96, ``save_pytree`` into a temporary
    directory, ``load_pytree`` into a fresh ``init`` state, frames 97 on;
    flags and poses must equal the uninterrupted 4b run's bitwise."""
    import tempfile
    from pathlib import Path

    from ptzjax_torch.checkpoint import load_pytree, save_pytree
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_features
    from ptzjax_torch.slam import PTZSlam

    split = 96
    slam = PTZSlam(SLAMConfig(), intr)
    state = slam.init(*extract_features(imgs[0], slam.cfg), cams[0])
    state, first = slam.run_segment_pixels(state, imgs[1:split + 1])
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        save_pytree(path, state)
        fresh = PTZSlam(SLAMConfig(), intr)
        like = fresh.init(*extract_features(imgs[0], fresh.cfg), cams[0])
        loaded = load_pytree(path, like)
    _, rest = fresh.run_segment_pixels(loaded, imgs[split + 1:])
    for name in ("lost", "event", "keyframe", "reloc_success"):
        whole = getattr(infos_full, name)
        check(torch.equal(getattr(first, name), whole[:split]), f"4g: {name} before the save differs from 4b")
        check(torch.equal(getattr(rest, name), whole[split:]), f"4g: {name} after the resume differs from 4b")
    d_first = float((first.pose - infos_full.pose[:split]).abs().max())
    d_rest = (rest.pose - infos_full.pose[split:]).abs().amax(0).cpu().numpy()
    check(torch.equal(rest.pose, infos_full.pose[split:]), f"4g: resumed poses differ from 4b's by {d_rest}")
    print(
        f"checkpoint at frame {split}, resumed for frames {split + 1}-{imgs.shape[0] - 1}: flags equal to the "
        f"uninterrupted run, poses bitwise equal (max |d| before the save {d_first}, after {d_rest.max()}); "
        f"{int(rest.keyframe.sum())} keyframe inserts after the resume"
    )


# bench.py's trajectory flags (its sequence's period is 120 * 1.6 frames)
BENCH_FLAGS = ("--width", "1280", "--height", "720", "--f0", "2000", "--f-amp", "250", "--pan-amp", "0.12", "--period", "192")


def cli_run(argv: list[str]):
    """``run.main(argv)`` in this process, its printout kept for the caller:
    (RunResult, the launch counts of the run, host seconds, stdout)."""
    from ptzjax_torch import run

    out = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = run.main(argv)
    torch.cuda.synchronize()
    return res, read_counts(), time.perf_counter() - t0, out.getvalue()


def cli_phase(tmp: str, card: str) -> dict:
    """5a: the CLI at 720p, 192 frames, with --ba and checkpoints; then the
    same in KLT mode at 96 frames. Returns the launch counts by path."""

    by_path = {}
    for name, frames, extra, klt in (
        ("cli", 192, ("--ba", "--checkpoint-every", "64"), False),
        ("cli_klt", 96, ("--klt",), True),
    ):
        t0 = time.perf_counter()
        out = os.path.join(tmp, name)
        res, counts, wall, _ = cli_run(["--synthetic-images", "--frames", str(frames), *BENCH_FLAGS, *extra, "--out", out])
        recs, summary = res.records, res.summary
        traj = np.load(os.path.join(out, "trajectory.npz"))
        mae = float(np.abs(traj["pose"][:, 0] - traj["gt"][:, 0]).mean())
        want = expected_from_records(recs, klt)
        with open(os.path.join(out, "frames.jsonl")) as f:
            lines = sum(1 for _ in f)
        print(
            f"5a {name}: {frames} frames 720p: lost {summary['frames_lost']}, keyframes {summary['keyframes']}, "
            f"pan MAE {mae} rad ({summary['pan_mae_deg']} deg), reprojection RMSE "
            f"{summary['reprojection_rmse_px']} px; {lines} lines of frames.jsonl; launches {counts}"
        )
        check(summary["frames_lost"] == 0, f"5a {name}: {summary['frames_lost']} lost frames")
        check(mae < 3e-3 and summary["pan_mae_deg"] < np.rad2deg(3e-3), f"5a {name}: pan MAE {mae} rad")
        check(lines == frames - 1 and len(recs) == frames - 1, f"5a {name}: {lines} lines of frames.jsonl")
        check(counts == want, f"5a {name}: launches {counts}, call sites give {want}")
        if res.ba is not None:
            ckpts = sorted(f for f in os.listdir(out) if f.startswith("state_"))
            check(ckpts == ["state_000064.npz", "state_000128.npz"], f"5a {name}: checkpoints {ckpts}")
            before, after = res.ba["ba_cost_before"], res.ba["ba_cost_after"]
            check(np.isfinite(after) and after <= before, f"5a {name}: BA cost {before} -> {after}")
            print(f"5a {name}: checkpoints {ckpts}; --ba cost {before:.3f} -> {after:.3f} px^2")
        print(
            f"5a {name}: summary fps {summary['fps']:.2f} (the loop, {frames - 1} frames) [{card}]; "
            f"phase {time.perf_counter() - t0:.1f} s (main {wall:.1f} s, rendering included)"
        )
        by_path[name] = counts
    return by_path


def movers_phase(tmp: str, card: str) -> dict:
    """5b: --movers 8 (masked) at 720p, 96 frames."""
    from ptzjax_torch.kernels import harris_nms

    t0 = time.perf_counter()
    res, counts, _, _ = cli_run(
        ["--synthetic-images", "--movers", "8", "--frames", "96", *BENCH_FLAGS, "--out", os.path.join(tmp, "movers")]
    )
    summary, masked = res.summary, harris_nms.masked_launches
    want = expected_from_records(res.records)
    print(
        f"5b movers: 8 blobs masked, {summary['mover_pixel_frac_mid']} of the mid frame's pixels; lost "
        f"{summary['frames_lost']}, pan MAE {summary['pan_mae_deg']} deg; detection launches {counts['harris_nms']}, "
        f"with a mask {masked}; launches {counts}; fps {summary['fps']:.2f} [{card}]; phase {time.perf_counter() - t0:.1f} s"
    )
    check(summary["movers_masked"] is True and summary["frames_lost"] == 0, f"5b: {summary}")
    check(masked == counts["harris_nms"] > 0, f"5b: {masked} of {counts['harris_nms']} detection launches masked")
    check(counts == want, f"5b: launches {counts}, call sites give {want}")
    return counts


def forest_phase(imgs_np: np.ndarray, cams, intr, tmp: str, card: str) -> dict:
    """5c: the 4c sequence (BLACKOUT zeroed) through the CLI's loop with
    --reloc forest. Returns its launch counts."""
    from ptzjax_torch import run

    t0 = time.perf_counter()
    dark = imgs_np.copy()
    dark[BLACKOUT.start:BLACKOUT.stop] = 0.0
    args = run.parse_args(["--synthetic-images", "--reloc", "forest", "--out", os.path.join(tmp, "forest")])
    inputs = run.image_inputs(args, run.make_config(args), intr, cams, dark)
    reset_counts()
    torch.cuda.synchronize()
    with contextlib.redirect_stdout(io.StringIO()):
        res = run.run_sequence(args, inputs)
    torch.cuda.synchronize()
    counts = read_counts()
    recs = res.records
    frame = np.array([r["frame"] for r in recs])
    lost = np.array([r["lost"] for r in recs])
    kf_before = [int(f) for f in frame[np.array([r["keyframe"] for r in recs]) & (frame < BLACKOUT.start)]]
    recovered = [r["frame"] for r in recs if r["frame"] in res.forest_frames and r["reloc_success"]]
    print(
        f"5c forest, blackout {BLACKOUT.start}-{BLACKOUT.stop - 1}: keyframes inserted before it at {kf_before} "
        f"(and the bootstrap), lost frames {frame[lost].tolist()}, forest frames {res.forest_frames}, "
        f"recovered at {recovered[:1]}; launches {counts}"
    )
    check(kf_before, "5c: no keyframe inserted before the blackout")
    check(lost[np.isin(frame, list(BLACKOUT))].any(), "5c: no frame lost in the blackout")
    check(recovered and recovered[0] <= BLACKOUT.stop - 1 + 2, f"5c: the forest recovered at {recovered[:1]}")
    first = recovered[0]
    check(res.forest_frames == list(range(res.forest_frames[0], first + 1)), f"5c: forest frames {res.forest_frames}")
    late = frame >= first + 15
    check(not lost[late].any(), f"5c: lost frames after recovery at {frame[late & lost]}")
    after = [r for r in recs if r["frame"] > first and r["event"] == "track"]
    mae = float(np.mean([abs(r["pose"][0] - cams[r["frame"], 0]) for r in after]))
    check(mae < 3e-3, f"5c: pan MAE after recovery {mae}")
    print(
        f"5c forest: first recovered frame {first}, pan MAE over the {len(after)} tracked frames after it {mae} rad; "
        f"fps {res.summary['fps']:.2f} [{card}]; phase {time.perf_counter() - t0:.1f} s"
    )
    return counts


def module_phase(tmp: str, card: str) -> None:
    """5d: the module entry point with no --device, in a subprocess."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "module")
    proc = subprocess.run(
        [sys.executable, "-m", "ptzjax_torch.run", "--synthetic", "--frames", "30", "--out", out],
        capture_output=True, text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    check(proc.returncode == 0, f"5d: exit {proc.returncode}: {proc.stderr[-2000:]}")
    check("device: cuda" in proc.stdout, f"5d: not on cuda: {proc.stdout[:200]}")
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    print(
        f"5d python3 -m ptzjax_torch.run --synthetic --frames 30 (no --device): exit 0 on cuda, lost "
        f"{summary['frames_lost']}, fps {summary['fps']:.2f} [{card}]; phase {time.perf_counter() - t0:.1f} s"
    )


def homography_frame_phase(imgs: torch.Tensor, cams, intr, card: str) -> None:
    """5e: the homography baseline over frames 1-40 of 4b's sequence, its
    features staged on the card, through the graph route (the default:
    ``track_homography_ekf``'s ``_graphs.VOGraph``, whose first frame runs
    eagerly and is then captured, the rest replays of one graph) and the
    eager route (``_graphs=False``): the graph route's infos and final
    carry bitwise the eager route's; wall a frame in turns (graph, eager,
    eager, graph) over calls of 40 frames, the graph route's on one
    ``VOGraph`` whose graph an earlier call captured (the call's set-up,
    timed apart, is the first call's); device time and kernels a frame (a
    pass under the profiler) and the busy share."""
    from ptzjax_torch._graphs import VOGraph
    from ptzjax_torch.baselines import init_vo, track_homography_ekf
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.frontend import extract_sequence

    cfg = SLAMConfig()
    xy, desc, valid = extract_sequence(imgs[:41], cfg)
    state = init_vo(cams[0], xy[0], desc[0], valid[0], cfg)
    vo = VOGraph(state, cfg=cfg, intr=intr)
    routes = {
        True: lambda: vo.run(state, xy[1:], desc[1:], valid[1:]),
        False: lambda: track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg, _graphs=False),
    }

    def run(graphs: bool):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = routes[graphs]()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3, out

    setup, first = run(True)
    walls: dict = {True: [], False: []}
    outs = {}
    for graphs in (True, False, False, True):
        wall, outs[graphs] = run(graphs)
        walls[graphs].append(wall / 40)
    (s_g, i_g), (s_e, i_e) = outs[True], outs[False]
    check(_same(first, outs[True]), "5e frames: the graph route's replays differ from its first call")
    check(_same(i_g, i_e) and _same(s_g, s_e), "5e frames: the graph and eager routes differ")
    check(bool(i_g.updated.all()), "5e frames: a frame rejected")
    for graphs in (True, False):

        def traced():
            with profiled() as prof:
                run(graphs)
            return device_kernels(prof)

        kernels = repeat_until_same(traced, lambda k: (len(k),))
        check(kernels, "the profiler recorded no device time")
        by_name: dict = {}
        for name, us in kernels:
            by_name[name] = by_name.get(name, 0.0) + us
        device_ms = sum(by_name.values()) / 40 / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        wall = float(np.median(walls[graphs]))
        print(
            f"5e baseline frames 1-40 of 4b's sequence, {'graph' if graphs else 'eager'} route: wall {wall:.3f} ms a "
            f"frame (passes {', '.join(f'{w:.3f}' for w in walls[graphs])}), device {device_ms:.4f} ms "
            f"({len(kernels) / 40:.1f} kernels, busy {100 * device_ms / wall:.1f}%); largest: "
            + "; ".join(f"{name[:60]} {us / 40 / 1e3:.4f} ms" for name, us in top)
            + (f"; the first call (the eager frame, the capture, 39 replays) {setup:.3f} ms" if graphs else "")
            + f"; infos and final carry bitwise between the routes [{card}]"
        )


def homography_phase(tmp: str, card: str) -> dict:
    """5e: --tracker homography on --synthetic-images at 720p, 96 frames,
    bench.py's trajectory flags; its first 8 frames against the same CLI on
    the CPU. Returns its launch counts."""
    t0 = time.perf_counter()
    argv = ["--synthetic-images", *BENCH_FLAGS, "--tracker", "homography"]
    res, counts, _, _ = cli_run([*argv, "--frames", "96", "--out", os.path.join(tmp, "homography")])
    recs, summary = res.records, res.summary
    pose = np.array([r["pose"] for r in recs])
    traj = np.load(os.path.join(tmp, "homography", "trajectory.npz"))
    err = np.abs(pose - traj["gt"])
    mae20 = float(err[:20, 0].mean())
    inliers = np.array([r["num_matches"] for r in recs])
    want = {
        "harris_nms": 96, "gather_windows": 0, "match_scores": 95, "cholesky": 0, "lk_track": 0,
        "build_pyramid": 0, "describe_keypoints": 96,
    }
    print(
        f"5e homography: 96 frames 720p: rejected {summary['frames_lost']}, pan MAE first 20 frames {mae20} rad, "
        f"all frames {float(err[:, 0].mean())} rad; inliers a frame mean {float(inliers.mean()):.1f}, min "
        f"{int(inliers.min())}; launches {counts}; fps {summary['fps']:.2f} (tracking only) [{card}]"
    )
    check(len(recs) == 95 and np.isfinite(pose).all(), f"5e: {len(recs)} records")
    check(summary["frames_lost"] == 0, f"5e: {summary['frames_lost']} frames rejected")
    check(mae20 < 5e-3, f"5e: pan MAE over the first 20 frames {mae20} >= 5e-3")
    check(counts == want, f"5e: launches {counts}, call sites give {want}")
    # the first 8 frames through the same CLI on the CPU (plain versions)
    from ptzjax_torch import run

    with contextlib.redirect_stdout(io.StringIO()):
        cpu = run.main([*argv, "--frames", "8", "--out", os.path.join(tmp, "homography_cpu"), "--device", "cpu"])
    n_cpu = len(cpu.records)
    d = np.abs(np.array([r["pose"] for r in cpu.records]) - pose[:n_cpu])
    check([r["lost"] for r in cpu.records] == [r["lost"] for r in recs[:n_cpu]], "5e: card and CPU flags differ")
    check(
        [r["num_matches"] for r in cpu.records] == inliers[:n_cpu].tolist(), "5e: card and CPU inlier counts differ"
    )
    check(d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, f"5e: card and CPU poses differ by {d.max(0)}")
    print(
        f"5e homography: first {n_cpu + 1} frames card vs CPU: flags and inlier counts equal, max |d pan,tilt| "
        f"{d[:, :2].max()} rad, max |d f| {d[:, 2].max()} px; phase {time.perf_counter() - t0:.1f} s"
    )
    return counts


def offline_phase(tmp: str, card: str, frames: int = 192) -> dict:
    """5f: --offline on 5a's sequence (one process: the one-device mesh).
    Returns its launch counts."""
    t0 = time.perf_counter()
    res, counts, _, _ = cli_run(
        ["--synthetic-images", "--offline", "--frames", str(frames), *BENCH_FLAGS, "--out", os.path.join(tmp, "offline")]
    )
    recs, s = res.records, res.summary
    traj = np.load(os.path.join(tmp, "offline", "trajectory.npz"))
    mae = float(np.abs(traj["pose"][:, 0] - traj["gt"][:, 0]).mean())
    want = {**expected_from_records(recs), "harris_nms": frames, "describe_keypoints": frames}
    print(
        f"5f offline: {frames} frames 720p, mesh of {s['mesh_devices']}: lost {s['frames_lost']}, keyframes "
        f"{s['keyframes']}, pan MAE {mae} rad; BA cost {s['ba_cost_before']:.3f} -> {s['ba_cost_after']:.3f} px^2; "
        f"frontend {s['frontend_s']:.3f} s, tracking {s['tracking_s']:.3f} s, BA {s['ba_s']:.3f} s; "
        f"launches {counts}; fps {s['fps']:.2f} (frontend + tracking) [{card}]"
    )
    check(len(recs) == frames - 1 and s["frames_lost"] == 0, f"5f: {s['frames_lost']} lost frames")
    check(s["keyframes"] >= 1, "5f: no keyframe inserted, the BA has one frozen camera")
    check(mae < 3e-3, f"5f: pan MAE {mae} >= 3e-3")
    check(np.isfinite(s["ba_cost_after"]) and s["ba_cost_after"] <= s["ba_cost_before"], f"5f: BA cost {s}")
    check(counts == want, f"5f: launches {counts}, call sites give {want}")
    print(f"5f offline: phase {time.perf_counter() - t0:.1f} s")
    return counts


def soak_phase(tmp: str, card: str) -> dict:
    """5h: ``ptzjax_torch.soak.main`` at its defaults: 10,080 continuous
    720p frames of its periodic 720-frame stack at the SLAMConfig defaults
    (``descriptor_f_ref`` 2,000) on the graph route, checkpoints every
    2,400. Checks the reference's four criteria, keyframe eviction at the
    cap, the resume from the first checkpoint bitwise, requested and
    reserved memory flat after the first chunk, the final whole-map BA, and
    the launches against the call sites' for ``init`` and the 10,080 frames
    (the warm-up chunk's and the resume's are not counted). Returns the
    launch counts."""
    from ptzjax_torch import soak

    out = os.path.join(tmp, "soak")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        soak.main(["--out", out])
        failed = None
    except SystemExit as err:   # a failed criterion: report what the run saw, then fail
        failed = err
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(out, "summary.json")) as f:
        s = json.load(f)
    with open(os.path.join(out, "frames.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    want = expected_from_records(recs)
    occ = [{k: o[k] for k in ("frame", "map_rays", "keyframes", "ekf_slots")} for o in s["occupancy_checkpoints"]]
    mem = ", ".join(
        f"{m['frame']}: {m['memory_requested']} / {m['memory_allocated']} / {m['memory_reserved']} B" for m in s["memory"]
    )
    fmt = ", ".join
    print(
        f"5h soak: {s['frames']} frames 720p at SLAMConfig defaults: criteria {s['pass']}; lost {s['frames_lost']} "
        f"({s['lost_episodes']} episodes); pan MAE {s['pan_mae_deg']} deg, by quartile "
        f"[{fmt(str(v) for v in s['pan_mae_deg_quartiles'])}] deg, last eighths {s['tail_eighths_pan_mae_deg']}; "
        f"occupancy {occ}, peak map {s['peak_map_rays']}/{s['map_ray_capacity']}; keyframe inserts "
        f"{s['keyframe_inserts']}, evictions {s['keyframe_evictions']} at cap {s['keyframe_capacity']}"
    )
    walls = np.array(s["chunk_wall_s"]) * 1e3
    slow = np.argsort(walls)[::-1][:5]
    print(
        f"5h soak: fps {s['fps']} overall, by quartile [{fmt(str(v) for v in s['fps_quartiles'])}] "
        f"(first/last {s['fps_first_quartile']} / {s['fps_last_quartile']}); chunk walls of {len(walls)} chunks: "
        f"median {np.median(walls):.1f} ms, first five [{fmt(f'{w:.1f}' for w in walls[:5])}] ms, slowest "
        f"[{fmt(f'{k}: {walls[k]:.1f}' for k in slow)}] ms [{card}]"
    )
    print(f"5h soak: memory requested / allocated / reserved after frame {mem} [{card}]")
    print(f"5h soak: resume {s.get('resume')}; final BA {s['final_ba']} [{card}]")
    print(f"5h soak: launches {counts}; phase {seconds:.1f} s, by part {s['seconds']} [{card}]")
    check(failed is None, f"5h: the soak failed its criteria ({failed}): {s['pass']}, resume {s.get('resume')}")
    check(s["keyframe_evictions"] >= 1, f"5h: no keyframe eviction ({s['keyframe_inserts']} inserts)")
    check(any(o["keyframes"] == s["keyframe_capacity"] for o in occ), f"5h: the keyframe count never reached its cap: {occ}")
    check(s["resume"]["bitwise"], f"5h: the resume at {s['resume']['from']} differs: {s['resume']}")
    check(s["pass"]["memory"], f"5h: requested or reserved memory grew after the first chunk: {mem}")
    ba = s["final_ba"]
    check(np.isfinite(ba["ba_cost_after"]) and ba["ba_cost_after"] <= ba["ba_cost_before"], f"5h: final BA {ba}")
    check(len(recs) == s["frames"], f"5h: {len(recs)} lines of frames.jsonl")
    check(counts == want, f"5h: launches {counts}, call sites give {want}")
    return counts


def one_rank_nccl_phase(dev, card: str) -> dict:
    """5g: ``dist.run_sharded`` in a one-rank NCCL group on the card, on the
    BA bench problem, bitwise ``ba.run`` (and, with a Huber width,
    ``ba.run_robust``) without a group. Returns its launch counts (none of
    the four kernels is on this path)."""
    import socket

    import torch.distributed as tdist

    from ptzjax_torch import ba, dist
    from ptzjax_torch.config import SLAMConfig

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.initialize_multihost(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, backend="nccl", timeout_s=120)
    reset_counts()
    try:
        prob, bintr = bench_ba_problem(dev)
        meshes = {"one-device mesh": dist.make_mesh(), "mesh holding the group": dist.Mesh(("obs",), (1,), None, tdist.group.WORLD)}
        check(meshes["one-device mesh"].group is None, "5g: a one-process world made a group")
        for huber in (0.0, 2.0):
            cfg = SLAMConfig(ba_iters=20, ba_huber_px=huber)

            def plain():
                return ba.run_robust(prob, bintr, cfg) if huber else ba.run(prob, bintr, cfg)

            def sharded():
                return dist.run_sharded(prob, bintr, cfg, meshes["mesh holding the group"])

            want = plain()
            for name, mesh in meshes.items():
                got = dist.run_sharded(prob, bintr, cfg, mesh)
                torch.cuda.synchronize()
                for field in ba.BAResult._fields:
                    a, b = getattr(got, field), getattr(want, field)
                    check(a.device == b.device and torch.equal(a, b), f"5g {name}, huber {huber}: {field} differs")
            # wall per solve, in turns (without, with, with, without) x 4:
            # the host's speed drifts within a call
            walls: dict = {plain: [], sharded: []}
            for _ in range(4):
                for fn in (plain, sharded, sharded, plain):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[fn].append((time.perf_counter() - t1) * 1e3)
            print(
                f"5g run_sharded, one-rank NCCL group, huber {huber}: bitwise ba.run{'_robust' if huber else ''} "
                f"through both meshes; cost {float(want.initial_cost):.1f} -> {float(want.cost):.1f} px^2; wall "
                f"median {np.median(walls[sharded]):.3f} ms through the group, {np.median(walls[plain]):.3f} ms "
                f"without (8 solves each, in turns) [{card}]"
            )
        counts = read_counts()
    finally:
        tdist.destroy_process_group()
    print(f"5g: launches {counts}; phase {time.perf_counter() - t0:.1f} s")
    return counts


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
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s [{card}]")
    if "--detect-stage" in sys.argv[1:]:
        imgs_np, _, _ = render(1, 1280, 720)
        print(detect_stage_line(torch.from_numpy(imgs_np[0]).to(dev), card))
        return 0
    if "--frame-walls" in sys.argv[1:]:
        imgs_np, cams, intr = render(80, 1280, 720)
        print(frame_walls(torch.from_numpy(imgs_np).to(dev), cams, intr, card))
        return 0

    w, h, frames = 1280, 720, 192
    imgs_np, cams, intr = render(frames, w, h)
    imgs = torch.from_numpy(imgs_np).to(dev)

    # Every phase that times the graph route runs before the first profiler
    # session (phases 3, 4f and the profiled passes of 4d and 5e, last): after
    # one, a launch of a graph with conditional nodes makes the host wait for
    # the card, which would swell those walls.

    # 4a. the first frames through the same code on the CPU (plain
    # versions) and on the card, in re-detect and in KLT mode: the
    # reference check on a small input
    n_ref = 8
    for mode, run in (("re-detect", lambda x: run_slice(x, cams, intr)), ("KLT", lambda x: run_klt(x, cams, intr))):
        _, info_cpu = run(torch.from_numpy(imgs_np[:n_ref]))
        _, info_gpu = run(imgs[:n_ref])
        torch.cuda.synchronize()
        p_cpu, p_gpu = info_cpu.pose.numpy(), info_gpu.pose.cpu().numpy()
        dpose = np.abs(p_cpu - p_gpu)
        check(np.array_equal(info_cpu.lost.numpy(), info_gpu.lost.cpu().numpy()), f"{mode}: CPU/GPU lost flags differ")
        check(dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, f"{mode}: CPU/GPU poses differ by {dpose.max(0)}")
        print(
            f"first {n_ref} frames, {mode}, card vs CPU: max |d pan,tilt| {dpose[:, :2].max()} rad, "
            f"max |d f| {dpose[:, 2].max()} px"
        )
    # 4b. the main path, counted: each kernel as often as its call sites say;
    # then a second pass of the sequence on the same PTZSlam (its frame
    # graph captured by the first: set-up apart from the steady state)
    from ptzjax_torch.config import SLAMConfig
    from ptzjax_torch.slam import PTZSlam

    slam_4b = PTZSlam(SLAMConfig(), intr, device=dev)
    for label in ("with its captures", "second pass on the same PTZSlam"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_4b, infos_4b = run_slice(imgs, cams, intr, slam=slam_4b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_4b = read_counts()
        if label == "with its captures":
            state, infos, launches = state_4b, infos_4b, counts_4b
        want = expected_counts(infos_4b)
        print(f"launches over the {frames}-frame main path ({label}): {counts_4b}")
        check(counts_4b == want, f"{label}: launches {counts_4b}, call sites give {want}")
        # kernel E runs in KLT mode only (4e); B on no main path
        check(
            all(v > 0 for k, v in counts_4b.items() if k not in ("lk_track", "build_pyramid", "gather_windows")),
            f"{label}: a kernel never launched: {counts_4b}",
        )
        pose = infos_4b.pose.cpu().numpy()
        lost = infos_4b.lost.cpu().numpy()
        event = infos_4b.event.cpu().numpy()
        inserts = int(infos_4b.keyframe.sum())
        check(pose.shape == (frames - 1, 3) and np.isfinite(pose).all(), f"{label}: poses not finite / wrong shape")
        pan_mae = float(np.abs(pose[:, 0] - cams[1:, 0]).mean())
        tilt_mae = float(np.abs(pose[:, 1] - cams[1:, 1]).mean())
        f_mae = float(np.abs(pose[:, 2] - cams[1:, 2]).mean())
        print(
            f"slice ({label}): {frames} frames 720p at SLAMConfig defaults: lost {int(lost.sum())}, "
            f"keyframe inserts {inserts} (each with windowed BA), relocalizations "
            f"{int((event == 1).sum())}, kf stored {int(state_4b.kf.count)}, "
            f"pan MAE {pan_mae} rad, tilt MAE {tilt_mae} rad, f MAE {f_mae} px"
        )
        print(f"slice wall clock ({label}): {wall:.3f} s, {frames / wall:.2f} frames/s [{card}]")
        check(not lost.any(), f"{label}: lost frames at {np.nonzero(lost)[0]}")
        check(pan_mae < 3e-3, f"{label}: pan MAE {pan_mae} >= 3e-3")
        check(inserts >= 1 and int(state_4b.kf.count) >= 2, f"{label}: no keyframe insert ran windowed BA")
    check(torch.equal(infos_4b.pose, infos.pose), "4b: the second pass's poses differ from the first's")
    print(
        f"4b set-up (the frame graph's captures, assembly and instantiation, pool growth): "
        f"{describe_captures(captures(slam_4b))} [{card}]"
    )

    # 4c. blackout, relocalization and recovery, in both reloc modes
    by_path = {"main": launches}
    for mode in ("map", "keyframe"):
        by_path[f"blackout_{mode}"] = blackout_phase(imgs, cams, intr, mode, card)
    # 4e. the sequence in KLT mode, counted
    by_path["klt"] = klt_phase(imgs, cams, intr, card)

    # 4d, the wall passes (their profiled passes come last)
    walls_4d = frame_phase(imgs, cams, intr, card)
    walls_klt, by_path["klt_frames_40_79"] = mode_frame_phase(imgs, cams, intr, card, "KLT")
    walls_features, by_path["features_frames_40_79"] = mode_frame_phase(imgs, cams, intr, card, "features")
    # 4h. the graph route against the eager one, in every mode
    graph_phase(imgs, cams, intr, card)

    # 4g. checkpoint at frame 96 and resume: the 4b run again
    resume_phase(imgs, cams, intr, infos, card)

    # 5. the CLI: 5a (re-detect with BA and checkpoints, then KLT), 5b
    # (movers), 5c (forest relocalization), 5d (the module entry point), 5e
    # (the homography baseline), 5f (offline); 5g (sharded BA, one NCCL rank)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(cli_phase(tmp, card))
        by_path["cli_movers"] = movers_phase(tmp, card)
        by_path["cli_forest_blackout"] = forest_phase(imgs_np, cams, intr, tmp, card)
        module_phase(tmp, card)
        by_path["cli_homography"] = homography_phase(tmp, card)
        by_path["cli_offline"] = offline_phase(tmp, card)
        # 5h. the 10,080-frame soak (a graph-route wall: before the profiler)
        by_path["soak"] = soak_phase(tmp, card)
    by_path["dist_one_rank_nccl"] = one_rank_nccl_phase(dev, card)


    # 3. kernels vs plain at main-path shapes (the profiler from here on)
    kernels = kernel_phase(imgs[0], card)
    kernels.append(matcher_phase(dev, card))
    kernels.append(cholesky_phase(dev, card))
    # 3e. the LK stage (kernel E's two launches)
    kernels.extend(lk_stage(dev, card))
    # 3f. the descriptor stage (kernel F)
    kernels.append(describe_stage(imgs, cams, intr, card))
    for k in kernels:
        k["launches"] = (by_path["klt"] if k["name"] in ("lk_track", "build_pyramid") else launches)[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items() if k["name"] in c}

    # 4d, the profiled passes: device time and kernels per frame kind
    frame_phase(imgs, cams, intr, card, walls_4d)
    mode_frame_phase(imgs, cams, intr, card, "KLT", walls_klt)
    mode_frame_phase(imgs, cams, intr, card, "features", walls_features)
    # 4f. whole-map BA on the 4b state, and the BA bench problem
    ba_phase(state, intr, dev, card)

    # 5e. the baseline's frames on both routes, profiled
    homography_frame_phase(imgs, cams, intr, card)

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
