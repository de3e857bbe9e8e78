"""Long soak: 10,080 continuous from-pixels 720p frames through the online
loop, the stores at capacity. Port of ``benchmarks/soak.py``.

The bounded-store design (fixed-capacity EKF slots, the map-ray free list
with cull and merge, keyframe eviction) claims that hours of capacity
pressure are safe. This run checks it on one card, with the reference's
pass criteria:

  * no silent drift: the pan error plateaus (last-quartile MAE below
    max(2x the first quartile's, 0.05 deg), the last eighth no more than
    1.15x the eighth before it), every pose finite;
  * lost frames <= 1% of the run;
  * stable throughput: last-quartile fps > 0.9x the first quartile's;
  * bounded stores: peak map-ray occupancy <= the capacity.

and two checks the reference does not make: the state saved at the first
checkpoint, loaded into a fresh ``PTZSlam``, continues for one stack
bitwise as the uninterrupted run did; and on the card neither the bytes
the live tensors requested nor the allocator's ``memory_reserved`` grow
after the first chunk (``memory_allocated`` is recorded beside them).

The trajectory is exactly periodic (the periods divide the stack), so a
rendered stack of 720 frames fed cyclically (frame t is stack index t mod
720) is one continuous camera path, and the ground truth cycles with it.

Usage::

    python -m ptzjax_torch.soak [--frames 10080] [--stack 720] [--chunk 120]
        [--checkpoint-every 2400] [--out DIR] [--device cpu]

prints one JSON line ``{"metric": "long_soak_10k", ...}`` and writes
``frames.jsonl``, ``summary.json`` and the checkpoints to ``--out``. It
runs on the card unless ``--device cpu`` asks for the CPU, and exits 1 when
a criterion fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ptzjax_torch import _device, synth
from ptzjax_torch._graphs import captured_rise
from ptzjax_torch.checkpoint import load_pytree, save_pytree
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics
from ptzjax_torch.slam import FrameInfo, PTZSlam, infos_to_dicts


def trajectory(stack: int, f0: float = 2000.0, f_amp: float = 250.0) -> np.ndarray:
    """(stack, 3) float32 (pan, tilt, focal): the reference's periodic path,
    whose periods (stack, stack / 2, stack / 3) divide ``stack``, so frame
    ``stack`` is frame 0 again."""
    t = np.arange(stack, dtype=np.float64)
    return np.stack(
        [
            0.12 * np.sin(2 * np.pi * t / stack) + 0.05 * np.sin(2 * np.pi * t / (stack // 3)),
            -0.05 + 0.02 * np.sin(2 * np.pi * t / (stack // 2)),
            f0 + f_amp * np.sin(2 * np.pi * t / stack),
        ],
        -1,
    ).astype(np.float32)


def render_stack(cams: np.ndarray, width: int, height: int):
    """``cams``' frames of ``synth.make_panorama(seed=0)`` as a (T, height,
    width) float32 array, rendered on a pool of threads (numpy releases the
    interpreter lock). Returns (imgs, intr)."""
    intr = Intrinsics.create(width / 2.0, height / 2.0)
    pano = synth.make_panorama(seed=0)
    with ThreadPoolExecutor() as pool:
        frames = list(pool.map(lambda c: synth.render_image(pano, c, intr, width, height), cams))
    return np.stack(frames).astype(np.float32), intr


def _host(infos: FrameInfo) -> FrameInfo:
    return FrameInfo(*(v.cpu() for v in infos))


def _concat(infos: list[FrameInfo]) -> FrameInfo:
    return FrameInfo(*(torch.cat(list(field)) for field in zip(*infos)))


def _memory(device: torch.device) -> dict:
    """The caching allocator's readings in bytes (None off the card):
    ``memory_allocated`` and ``memory_reserved``, and the bytes the live
    tensors asked for (``memory_requested``). ``memory_allocated`` counts
    whole cache blocks, and the allocator may hand a request a block up to
    1 MiB larger when its cache is fragmented, so only the other two
    measure growth."""
    if device.type != "cuda":
        return dict.fromkeys(("memory_allocated", "memory_reserved", "memory_requested"))
    stats = torch.cuda.memory_stats(device)
    return {
        "memory_allocated": stats["allocated_bytes.all.current"],
        "memory_reserved": stats["reserved_bytes.all.current"],
        "memory_requested": stats["requested_bytes.all.current"],
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunks(slam: PTZSlam, state, imgs, start: int, frames: int, chunk: int, walls=None):
    """Frames ``start`` .. ``start + frames - 1`` (frame t is stack index t
    mod len(imgs)) in calls of ``chunk``; each call's infos come to the host,
    which is its fence. Yields (state, infos, frames done)."""
    stack = imgs.shape[0]
    k = start
    while k < start + frames:
        s = k % stack
        tc = time.perf_counter()
        state, infos = slam.run_segment_pixels(state, imgs[s:s + chunk])
        infos = _host(infos)
        if walls is not None:
            walls.append(time.perf_counter() - tc)
        k += chunk
        yield state, infos, k


def run_soak(
    cfg: SLAMConfig, intr: Intrinsics, imgs, cams: np.ndarray, *, frames: int, chunk: int,
    checkpoint_every: int, out: str, device=None, resume_at: int | None = None, _graphs: bool = True,
) -> dict:
    """The soak loop: ``init`` on stack frame 0, one discarded chunk (the
    warm-up: on the card it captures the frame graph), then ``frames``
    frames, frame t fed as stack index t mod len(imgs) through
    ``PTZSlam.run_segment_pixels`` in calls of ``chunk`` frames; every
    ``checkpoint_every`` frames the state is saved to ``out`` and the
    occupancy recorded. Then the checkpoint at ``resume_at`` (None: the
    first) is loaded into a fresh ``PTZSlam`` and run on for one stack, and
    the final state gets one whole-map ``bundle_adjust``.

    Args:
      imgs: (stack, H, W) frames (numpy or a tensor); moved to the device
        once. ``cams``: (stack, 3) ground-truth poses.
      device: the card unless ``"cpu"`` is given (no fallback).
      _graphs: False asks for the eager route on the card (parity
        checks only), as ``PTZSlam(..., _graphs=False)``.

    The warm-up's and the resume's kernel launches are not counted
    (``_graphs.captured_rise``): the counters rise by the ``init`` and the
    ``frames`` frames only.

    Returns the summary: the reference's keys, the pass criteria
    (``pass``), quartile fps and pan MAE, keyframe evictions, memory
    readings, the resume's comparison, the final BA and the phases'
    seconds. Writes ``frames.jsonl``, ``summary.json`` and
    ``state_<frame>.npz`` to ``out``.
    """
    stack = imgs.shape[0]
    if stack % chunk or frames % chunk:
        raise ValueError(f"chunk {chunk} must divide the stack ({stack}) and --frames ({frames})")
    os.makedirs(out, exist_ok=True)
    seconds: dict = {}
    t0 = time.perf_counter()
    slam = PTZSlam(cfg, intr, device=device, _graphs=_graphs)
    dev = slam.device
    imgs = torch.as_tensor(imgs).to(dev)   # one copy of the whole stack
    focal0 = torch.as_tensor(float(cams[0][2]), device=dev)
    feats0 = extract_features(imgs[0], slam.cfg, focal=focal0)
    state = slam.init(*feats0, cams[0])
    kf0 = int(state.kf.count)
    _sync(dev)
    seconds["init"] = time.perf_counter() - t0

    # the warm-up: one discarded chunk, the same program as the loop's
    t0 = time.perf_counter()
    captured_rise(lambda: slam.run_segment_pixels(state, imgs[:chunk]))
    _sync(dev)
    seconds["warm_up"] = time.perf_counter() - t0

    infos_all: list[FrameInfo] = []
    chunk_wall: list[float] = []
    occupancy: list[dict] = []
    memory: list[dict] = []
    saved: dict[int, str] = {}
    t0 = time.perf_counter()
    for state, infos, k in _chunks(slam, state, imgs, 0, frames, chunk, chunk_wall):
        infos_all.append(infos)
        if k == chunk:
            memory.append({"frame": k, **_memory(dev)})
        if checkpoint_every and k % checkpoint_every == 0:
            saved[k] = os.path.join(out, f"state_{k:06d}.npz")
            save_pytree(saved[k], state)
            reading = _memory(dev)
            memory.append({"frame": k, **reading})
            occupancy.append({
                "frame": k,
                "map_rays": int(state.rays.valid.sum()),
                "keyframes": int(state.kf.count),
                "ekf_slots": int(state.ekf.active.sum()),
                **reading,
            })
    _sync(dev)
    wall = time.perf_counter() - t0
    seconds["loop"] = wall

    info = _concat(infos_all)
    lost = info.lost.numpy()
    pose = info.pose.numpy()
    kf_flags = info.keyframe.numpy()
    gt = cams[np.arange(frames) % stack]
    pan_err_deg = np.degrees(np.abs(pose[:, 0] - gt[:, 0]))
    q = len(pan_err_deg) // 4
    mae_first_q = float(pan_err_deg[:q].mean())
    mae_last_q = float(pan_err_deg[-q:].mean())
    cq = len(chunk_wall) // 4
    fps_first_q = chunk * cq / sum(chunk_wall[:cq])
    fps_last_q = chunk * cq / sum(chunk_wall[-cq:])
    peak_map = max(o["map_rays"] for o in occupancy) if occupancy else -1

    with open(os.path.join(out, "frames.jsonl"), "w") as f:
        frame0 = 0
        for i in infos_all:
            for r in infos_to_dicts(i, frame0=frame0):
                r["pose"] = [float(x) for x in r["pose"]]
                f.write(json.dumps(r) + "\n")
            frame0 += chunk

    inserts = int(kf_flags.sum())
    kf_final = int(state.kf.count)
    summary = {
        "frames": frames,
        "fps": frames / wall,
        "fps_first_quartile": fps_first_q,
        "fps_last_quartile": fps_last_q,
        "frames_lost": int(lost.sum()),
        "pan_mae_deg": float(pan_err_deg.mean()),
        "pan_mae_deg_first_quartile": mae_first_q,
        "pan_mae_deg_last_quartile": mae_last_q,
        "keyframe_inserts": inserts,
        "occupancy_checkpoints": occupancy,
        "peak_map_rays": peak_map,
        "map_ray_capacity": cfg.max_map_rays,
        "keyframe_capacity": cfg.max_keyframes,
        # beyond the reference
        "fps_quartiles": [chunk * cq / sum(chunk_wall[i * cq:(i + 1) * cq]) for i in range(4)],
        "chunk_wall_s": chunk_wall,
        "pan_mae_deg_quartiles": [float(pan_err_deg[i * q:(i + 1) * q].mean()) for i in range(4)],
        # an insert at capacity evicts; every other one takes a free row
        "keyframe_evictions": inserts - (kf_final - kf0),
        "lost_episodes": int(np.sum(lost[1:] & ~lost[:-1]) + lost[0]),
        "memory": memory,
    }

    # the reference's pass criteria (benchmarks/soak.py), unchanged
    e = len(pan_err_deg) // 8
    tail2, tail1 = pan_err_deg[-2 * e:-e].mean(), pan_err_deg[-e:].mean()
    ok_drift = (
        mae_last_q < max(2.0 * mae_first_q, 0.05)
        and tail1 <= 1.15 * max(tail2, 1e-6)
        and np.isfinite(pose).all()
    )
    ok_fps = fps_last_q > 0.9 * fps_first_q
    ok_lost = int(lost.sum()) <= max(1, frames // 100)
    ok_store = peak_map <= cfg.max_map_rays
    # beyond the reference: neither the live tensors nor the allocator's
    # pool grow after the first chunk
    ok_memory = all(
        m[key] is None or m[key] <= memory[0][key]
        for m in memory for key in ("memory_requested", "memory_reserved")
    )
    summary["pass"] = {
        "drift": bool(ok_drift), "fps": bool(ok_fps), "lost": bool(ok_lost), "store": bool(ok_store),
        "memory": bool(ok_memory),
    }
    summary["tail_eighths_pan_mae_deg"] = [float(tail2), float(tail1)]

    # the resume: the checkpoint at resume_at, loaded into a fresh PTZSlam,
    # runs on for one stack, its launches not counted
    at = resume_at if resume_at is not None else (min(saved) if saved else None)
    if at is not None:
        if at not in saved:
            raise ValueError(f"resume_at={at}: no checkpoint was saved there ({sorted(saved)})")
        span = min(stack, frames - at)
        t0 = time.perf_counter()
        resumed: list[FrameInfo] = []

        def resume():
            fresh = PTZSlam(cfg, intr, device=dev, _graphs=_graphs)
            like = fresh.init(*feats0, cams[0])
            st = load_pytree(saved[at], like)
            resumed.extend(i for _, i, _ in _chunks(fresh, st, imgs, at, span, chunk))

        captured_rise(resume)
        seconds["resume"] = time.perf_counter() - t0
        got = _concat(resumed)
        want = FrameInfo(*(v[at:at + span] for v in info))
        same = [name for name in FrameInfo._fields if torch.equal(getattr(got, name), getattr(want, name))]
        summary["resume"] = {
            "from": at, "frames": span, "bitwise": len(same) == len(FrameInfo._fields),
            "fields_equal": same,
            "max_abs_pose_diff": float((got.pose - want.pose).abs().max()),
        }

    # whole-map BA on the final state (all keyframes, the first frozen)
    t0 = time.perf_counter()
    _, ba = slam.bundle_adjust(state)
    seconds["final_ba"] = time.perf_counter() - t0
    summary["final_ba"] = {**ba, "keyframes": kf_final, "seconds": seconds["final_ba"]}
    summary["seconds"] = seconds
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def metric_line(summary: dict) -> str:
    """The reference's one JSON line."""
    total, lost = summary["frames"], summary["frames_lost"]
    return json.dumps({
        "metric": "long_soak_10k",
        "value": round(summary["fps"], 1),
        "unit": (
            f"frames/s over {total} continuous 720p frames "
            f"(lost {lost}, pan MAE "
            f"{summary['pan_mae_deg']:.4f} deg, first/last-quartile "
            f"MAE {summary['pan_mae_deg_first_quartile']:.4f}/{summary['pan_mae_deg_last_quartile']:.4f} deg, "
            f"first/last-quartile fps {summary['fps_first_quartile']:.0f}/"
            f"{summary['fps_last_quartile']:.0f}, peak map occupancy {summary['peak_map_rays']}/"
            f"{summary['map_ray_capacity']}, {summary['keyframe_inserts']} keyframe "
            f"inserts at cap {summary['keyframe_capacity']})"
        ),
        "vs_baseline": round(summary["fps"] / 30.0, 2),
    })


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ptzjax_torch long soak (10k+ from-pixels frames)")
    ap.add_argument("--frames", type=int, default=10080)
    ap.add_argument("--stack", type=int, default=720, help="rendered frames")
    ap.add_argument("--chunk", type=int, default=120)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "ptzjax_soak"))
    ap.add_argument("--checkpoint-every", type=int, default=2400)
    ap.add_argument("--device", default=None, help="cpu asks for the CPU; the default is the card")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """The reference's run: the periodic stack at 720p, ``SLAMConfig(
    descriptor_f_ref=2000.0)`` otherwise at the defaults. Returns the
    summary; raises ``SystemExit(1)`` when a criterion fails."""
    args = _parser().parse_args(argv)
    if args.stack % args.chunk or args.frames % args.chunk:
        raise SystemExit("chunk must divide the stack and --frames")
    device = _device.resolve(args.device)   # no card and no --device cpu: raise before any work
    w, h = 1280, 720
    cfg = SLAMConfig(image_width=w, image_height=h, descriptor_f_ref=2000.0)
    cams = trajectory(args.stack)
    print(f"rendering {args.stack}-frame stack...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    imgs, intr = render_stack(cams, w, h)
    render_s = time.perf_counter() - t0
    imgs = torch.from_numpy(imgs).to(device)   # one copy of the whole stack
    summary = run_soak(
        cfg, intr, imgs, cams, frames=args.frames, chunk=args.chunk,
        checkpoint_every=args.checkpoint_every, out=args.out, device=device,
    )
    summary["seconds"]["render"] = render_s
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(metric_line(summary), flush=True)
    # the reference's four criteria, the allocator and the resume (where one ran)
    if not (all(summary["pass"].values()) and summary.get("resume", {}).get("bitwise", True)):
        p = summary["pass"]
        print(
            f"SOAK FAIL: drift_ok={p['drift']} fps_ok={p['fps']} lost_ok={p['lost']} store_ok={p['store']} "
            f"memory_ok={p['memory']} resume_bitwise={summary.get('resume', {}).get('bitwise')}",
            file=sys.stderr,
        )
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
