"""One run of one benchmark cell on the card.

    python3 -m ptzbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from this module's import to the window's start):
CUDA, the kernel library from the checkout's build cache, the frames
rendered on the card from the seed and kept in pinned host memory, one
``PTZSlam`` with ``init`` on frame 0, and one call through the cell's
entry point whose result is thrown away (it captures the frame graph).
Then the window: the traffic's calls for ``--seconds``, closed or open
loop, each call's ``FrameInfo`` read back as its fence. With ``--trace 1``
a stretch of the window's calls is run again from the state the window
had there, under ``torch.profiler``, after the window (a profiler session
makes every later launch of the frame graph wait for the card). Then the
program is freed and the reference replays the kept segments
(``check.py``).

The last line of standard output is the result: ``correct``,
``attempted`` (main-camera frames offered), ``failed`` (those the program
returned no tracked pose for: lost, non-finite or raised), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, ``look`` (every
number of the check and what a look at a reading needs, worst over the
segments, compared or not) and last ``checks``: each number compared
beside its limit. The last lines of
standard error are the same checks. No card, too few cards, or ``jax``,
``jaxlib``, ``flax`` or ``ptzjax`` loaded: an exit code other than 0 and
no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ptzjax")


def _log(*parts) -> None:
    print("ptzbench:", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class View(NamedTuple):
    """What a per-layer metric's reader reads (``metrics/*.py``)."""

    trace: object          # trace.Trace of the replayed stretch
    frames: int            # the stretch's frames
    walls_s: list          # the stretch's calls' walls in the (unprofiled) window
    branches: dict         # frames of the replay that took each frame-graph branch
    window_branches: dict  # ... of the window
    window_frames: int
    kernels: dict          # kernel -> its name in the trace (program.KERNELS)
    fields: dict           # SLAMConfig's fields as run
    frontend: str
    width: int
    height: int
    sample: object         # k -> [(previous frame, frame, pose)] from the stretch, on the host


class Stream:
    """The frames of a run: the rendered stacks in host memory and their
    poses."""

    def __init__(self, stacks: dict, poses: dict):
        self.stacks, self.poses = stacks, poses

    def frames(self, calls) -> "torch.Tensor":
        import torch

        parts = [self.stacks[c.source][c.row:c.row + c.count] for c in calls]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def frame(self, source: str, row: int):
        return self.stacks[source][row], self.poses[source][row]


def make_stream(traffic, width: int, height: int, device) -> Stream:
    import torch

    from ptzbench import frames

    pin = device.type == "cuda"
    stacks, poses = {}, {"main": traffic.main_poses()}
    away = traffic.away_poses()
    if away is not None:
        poses["away"] = away
    for source, cams in poses.items():
        pano = frames.make_panorama(traffic.scene[source], device)
        stacks[source] = frames.host_stack(pano, cams, width, height, pin=pin)
        del pano
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return Stream(stacks, poses)


def resolved_fields(config: dict, pose0) -> dict:
    """``SLAMConfig``'s fields as run: the AUTO descriptor reference focal
    (-1) resolved to frame 0's focal, as the CLI resolves it."""
    fields = dict(config["slam"])
    fields.setdefault("image_width", config["width"])
    fields.setdefault("image_height", config["height"])
    if fields.get("descriptor_f_ref", -1.0) < 0:
        fields["descriptor_f_ref"] = float(pose0[2])
    return fields


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(reg, cell, seed: int, seconds: float, traced: bool, device, t_import: float = T_IMPORT,
             program_cls=None, control: bool = False, frames: list | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell``: (the result, the check lines). ``device`` is the
    card; the harness's tests pass the CPU and, to plant a fault,
    ``program_cls`` (``faults.py``). ``calibrate.py`` alone asks for
    ``control``, which adds the control's numbers and looks to the result
    under ``control``, and for ``frames``, which gathers each kept
    segment's frame table (``check.frames_row``)."""
    import numpy as np
    import torch

    from ptzbench import check as checklib
    from ptzbench import program as proglib
    from ptzbench import trace as tracelib
    from ptzbench.generator import Traffic

    on_card = device.type == "cuda"
    config, mix = cell.config, cell.mix
    width, height, frontend = int(config["width"]), int(config["height"]), config["frontend"]
    phases = {"imports": time.perf_counter() - t_import}
    t = time.perf_counter()
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        phases["cuda"] = time.perf_counter() - t
        t = time.perf_counter()
        proglib.load_kernels()
        phases["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    traffic = Traffic(mix, seed)
    stream = make_stream(traffic, width, height, device)
    img0, pose0 = stream.frame("main", 0)
    phases["frames"] = time.perf_counter() - t
    t = time.perf_counter()
    fields = resolved_fields(config, pose0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prog = (program_cls or proglib.Program)(fields, frontend, width, height, device)
    state0, carry0 = prog.init(img0, pose0)
    if on_card:
        torch.cuda.synchronize(device)
    phases["init"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = traffic.warmup()
    prog.warm_up(state0, carry0, stream.frames([warm]))
    if on_card:
        torch.cuda.synchronize(device)
    phases["warm_up"] = time.perf_counter() - t
    counts0 = prog.branch_counts()
    setup_s = time.perf_counter() - t_import
    _log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f"; total {setup_s:.3f}")

    # the window; the set-up's objects frozen out of the garbage collector's
    # reach, so that a full collection in the window stays short
    gc.collect()
    gc.freeze()
    chk = mix["check"]
    keeper = checklib.Keeper(chk["picks"], chk["segment_calls"], np.random.default_rng([int(seed), 29]))
    trace_from = mix["trace"]["from"]
    trace_start = (0, state0, carry0) if trace_from == "first" else None
    log: list = []          # (call, wall seconds) of each call of the window
    latencies: list = []    # open loop: due to pose on the host, seconds a frame
    late: list = []         # open loop: how late each call was sent
    attempted = failed = lost = 0
    state, carry = state0, carry0
    open_loop = mix["loop"] == "open"
    t0 = time.perf_counter()
    t0_clock = time.time()
    t_end = t0
    for call in traffic.calls():
        if open_loop:
            if call.due_s >= seconds:
                break
            due = t0 + call.due_s
            while time.perf_counter() < due:   # spin: a sleep's wake-up comes late on a busy host
                pass
        elif time.perf_counter() - t0 >= seconds:
            break
        if trace_start is None and trace_from.startswith("tag:") and trace_from[4:] in call.tags:
            trace_start = (len(log), state, carry)
        keeper.before(call, state, carry, first=not log)
        t_call = time.perf_counter()
        state, carry, infos = prog.call(state, carry, stream.frames([call]))
        t_end = time.perf_counter()
        keeper.after(call, infos, state)
        log.append((call, t_end - t_call))
        if open_loop:
            late.append(t_call - due)
            latencies.extend([t_end - due] * call.count)
        lost += int(infos.lost.sum())
        if call.source == "main":
            attempted += call.count
            bad = infos.lost.bool() | ~torch.isfinite(infos.pose).all(-1)
            failed += int(bad.sum())
    keeper.finish(state)
    wall = t_end - t0
    frames_done = sum(c.count for c, _ in log)
    counts = {k: v - counts0[k] for k, v in prog.branch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    walls_ms = [1e3 * w for _, w in log]
    _log(f"window: {frames_done} frames in {len(log)} calls, {wall:.4f} s; branches {counts}; "
         f"attempted {attempted}, failed {failed}, lost frames {lost}; call walls ms p10 "
         f"{percentile(walls_ms, 10):.3f}, p50 {percentile(walls_ms, 50):.3f}, p90 {percentile(walls_ms, 90):.3f}, "
         f"max {max(walls_ms):.3f}")
    if not open_loop:   # each call's wall, beside the clock time the window opened (to read against the card's clocks)
        _log(f"call walls ms from {t0_clock:.3f}: " + " ".join(f"{w:.1f}" for w in walls_ms))

    end_to_end = {
        "setup_s": setup_s,
        "fps": frames_done / wall if wall > 0 else math.nan,
        "latency_p95_ms": 1e3 * percentile(latencies, 95),
    }
    if open_loop:
        _log(f"latency ms: p50 {1e3 * percentile(latencies, 50)}, p95 {end_to_end['latency_p95_ms']}, "
             f"p99 {1e3 * percentile(latencies, 99)}, max {1e3 * max(latencies)} over {len(latencies)} frames; "
             f"generator late ms: p50 {1e3 * percentile(late, 50)}, p99 {1e3 * percentile(late, 99)}, "
             f"max {1e3 * max(late)}")

    result_device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    metrics: dict = {}
    breakdown = None
    if traced:
        if trace_start is None:
            trace_start = (0, state0, carry0)
        i0, st, cr = trace_start
        stretch, n = [], 0
        for call, w in log[i0:]:
            if stretch and n >= mix["trace"]["frames"]:
                break
            stretch.append((call, w))
            n += call.count
        before = prog.branch_counts()
        with tracelib.session() as got:
            for call, _ in stretch:
                st, cr, _ = prog.call(st, cr, stream.frames([call]))
        tr = got[0]
        replay = {k: v - before[k] for k, v in prog.branch_counts().items()}
        del st, cr

        def sample(k: int):
            picks = np.linspace(0, n - 1, k).round().astype(int)
            flat = [(c.source, c.row + j) for c, _ in stretch for j in range(c.count)]
            out = []
            for p in picks:
                source, row = flat[p]
                prev_row = row - 1 if row > 0 else row
                out.append((stream.stacks[source][prev_row], stream.stacks[source][row], stream.poses[source][row]))
            return out

        view = View(
            tr, n, [w for _, w in stretch], replay, counts, frames_done, dict(proglib.KERNELS), fields,
            frontend, width, height, sample,
        )
        for m in cell.per_layer:
            value = reg.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        busy = tracelib.busy_s(tr.device_ops)
        result_device["busy_s"] = busy
        result_device["window_s"] = tr.window_s
        breakdown = {"device_ops": tracelib.top_ops(tr.device_ops), "idle_gaps": tracelib.idle_gaps(tr)}
        _log(f"trace: {n} frames in {len(stretch)} calls from call {i0}, {len(tr.device_ops)} device records, "
             f"busy {busy} s of {tr.window_s} s, branches {replay}")
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}

    # the check, after the program and its graphs are freed
    gc.unfreeze()
    segments = keeper.segments()
    del state, carry, state0, carry0, trace_start
    prog.close()
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rp = checklib.Replay(fields, frontend, width, height, stream.frames, img0, pose0)
    t_check = time.perf_counter()
    numbers, rows, ctl = checklib.check(rp, segments, device, control, frames)
    for row in rows:
        _log("segment", json.dumps(row))
    correct, shown = checklib.verdict(numbers, cell.limits)
    _log(f"check: {len(rows)} segments, {sum(r['frames'] for r in rows)} frames, "
         f"{time.perf_counter() - t_check:.2f} s; card {power_limit() if on_card else 'none'}")

    result = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": result_device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = ctl
    result["look"] = checklib.worst_all(rows)
    result["checks"] = shown
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one ptzjax_torch benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "ptzbench" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "ptzbench" / "triton"))

    from ptzbench.registry import Registry

    reg = Registry(ROOT)
    cell = reg.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found")
        return 2
    import ptzjax_torch  # noqa: F401  (the program: a checkout without it cannot run)

    result, lines = run_cell(reg, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        _log(f"modules the benchmark may not load are loaded: {bad}")
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
