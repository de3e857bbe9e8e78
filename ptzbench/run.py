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

A configuration with ``cameras`` N > 1 runs N genlocked cameras on the
card (``Camera``): each its own frames (``generator.py``), its own
``PTZSlam`` on a CUDA stream of its own, made and warmed one camera after
another in set-up, and its own host thread in the window; in an open loop
every camera's frame t falls due at the same tick. ``attempted`` and
``failed`` are summed over the cameras, ``fps`` is all cameras' frames
over the window's wall, ``latency_p95_ms`` the p95 over all cameras'
frames, and each number of the check the worst over all cameras.

The last line of standard output is the result: ``correct``,
``attempted`` (main-stack frames offered), ``failed`` (those the program
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
import contextlib  # noqa: E402
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
    cameras: int           # the genlocked cameras: frames, walls_s and both branch counts cover them all


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


class Camera:
    """One camera of a run: its traffic and frames, its program with its
    state and carry, and what its calls in the window gave. ``cuda`` is
    its CUDA stream (None at one camera: the current stream)."""

    def __init__(self, k: int, traffic, stream: Stream, cuda=None):
        self.k, self.traffic, self.stream, self.cuda = k, traffic, stream, cuda
        self.img0, self.pose0 = stream.frame("main", 0)
        self.fields = self.prog = self.keeper = None
        self.state = self.carry = self.state0 = self.carry0 = self.trace_start = None
        self.counts0: dict = {}
        self.log: list = []          # (call, wall seconds) of each call of the window
        self.latencies: list = []    # open loop: due to pose on the host, seconds a frame
        self.late: list = []         # open loop: how late each call was sent
        self.attempted = self.failed = self.lost = 0
        self.t_end: float | None = None
        self.stretch: list = []      # the traced replay's (call, wall in the window)
        self.replayed: dict = {}     # the replay's branch counts

    def on_stream(self):
        """The context in which the camera's work runs: its CUDA stream."""
        if self.cuda is None:
            return contextlib.nullcontext()
        import torch

        return torch.cuda.stream(self.cuda)

    def step(self, call, due: float | None = None) -> None:
        """One call of the window (``due``: its due time on
        ``time.perf_counter``'s clock, in an open loop)."""
        trace_from = self.traffic.mix["trace"]["from"]
        if self.trace_start is None and trace_from.startswith("tag:") and trace_from[4:] in call.tags:
            self.trace_start = (len(self.log), self.state, self.carry)
        self.keeper.before(call, self.state, self.carry, first=not self.log)
        t_call = time.perf_counter()
        self.state, self.carry, infos = self.prog.call(self.state, self.carry, self.stream.frames([call]))
        t_end = time.perf_counter()
        self.keeper.after(call, infos, self.state)
        self.log.append((call, t_end - t_call))
        self.t_end = t_end
        if due is not None:
            self.late.append(t_call - due)
            self.latencies.extend([t_end - due] * call.count)
        self.lost += int(infos.lost.sum())
        if call.source == "main":
            self.attempted += call.count
            bad = infos.lost.bool() | ~infos.pose.isfinite().all(-1)
            self.failed += int(bad.sum())

    def window_counts(self) -> dict:
        return {k: v - self.counts0[k] for k, v in self.prog.branch_counts().items()}

    def replay(self) -> None:
        """The traced stretch: the window's calls from the trace's start
        (the mix's ``trace``), run again from the state the window had
        there, until ``trace.frames`` frames."""
        i0, st, cr = self.trace_start if self.trace_start is not None else (0, self.state0, self.carry0)
        n = 0
        self.stretch = []
        for call, w in self.log[i0:]:
            if self.stretch and n >= self.traffic.mix["trace"]["frames"]:
                break
            self.stretch.append((call, w))
            n += call.count
        before = self.prog.branch_counts()
        for call, _ in self.stretch:
            st, cr, _ = self.prog.call(st, cr, self.stream.frames([call]))
        self.replayed = {k: v - before[k] for k, v in self.prog.branch_counts().items()}

    def release(self) -> None:
        """Drop the program, its graphs' memory pools and the states the
        window held (the kept segments stay with the keeper)."""
        self.state = self.carry = self.state0 = self.carry0 = self.trace_start = None
        self.prog.close()
        self.prog = None


def cameras_of(config: dict) -> int:
    """The configuration's genlocked cameras on the card (``cameras``, 1
    where it has none)."""
    n = int(config.get("cameras", 1))
    if n < 1:
        raise ValueError(f"run: cameras {n} in the configuration")
    return n


def on_threads(cams: list, device, work, lead=None) -> None:
    """``work(camera)`` for every camera at once, each on a host thread of
    its own inside its CUDA stream's context, while this thread runs
    ``lead()`` (the open loop's dispatcher) where given; re-raises the first
    error once every thread has ended."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    def run(cam):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with cam.on_stream():
            work(cam)

    with ThreadPoolExecutor(len(cams), thread_name_prefix="camera") as pool:
        futures = [pool.submit(run, cam) for cam in cams]
        if lead is not None:
            lead()
        for f in futures:
            f.result()


def window_on_threads(cams: list, device, seconds: float, open_loop: bool) -> tuple[float, list]:
    """The window at several cameras, each camera's calls on its own host
    thread (``on_threads``). Closed loop: each thread sends its next call
    when its last returns. Open loop: one dispatcher (this thread) sleeps,
    holding no lock the threads need, until each tick and hands every
    camera's call due then to its thread (``generator.genlocked``). Returns
    the window's start on ``time.perf_counter``'s clock and how late the
    dispatcher handed over each call (seconds; a camera's thread may start
    it later still, while its last call runs)."""
    import queue
    import threading

    from ptzbench.generator import genlocked

    start = threading.Event()
    t0: list = []
    handed: list = []
    queues = [queue.SimpleQueue() for _ in cams]

    def work(cam):
        start.wait()
        if open_loop:
            for call, due in iter(queues[cam.k].get, None):
                cam.step(call, due)
        else:
            for call in cam.traffic.calls():
                if time.perf_counter() - t0[0] >= seconds:
                    break
                cam.step(call)

    def dispatch():
        try:
            t0.append(time.perf_counter())
            start.set()
            if open_loop:
                for k, call in genlocked([cam.traffic for cam in cams], seconds):
                    due = t0[0] + call.due_s
                    wait = due - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    queues[k].put((call, due))
                    handed.append(time.perf_counter() - due)
        finally:
            start.set()
            for q in queues:
                q.put(None)

    on_threads(cams, device, work, dispatch)
    return t0[0], handed


def _latency(latencies: list, late: list) -> str:
    """An open loop's latencies and the generator's lateness (seconds), in
    ms, for standard error."""
    ms = [1e3 * x for x in latencies]
    return (f"p50 {percentile(ms, 50)}, p95 {percentile(ms, 95)}, p99 {percentile(ms, 99)}, max {max(ms)} over "
            f"{len(ms)} frames; generator late ms: p50 {1e3 * percentile(late, 50)}, p99 {1e3 * percentile(late, 99)}, "
            f"max {1e3 * max(late)}")


def run_cell(reg, cell, seed: int, seconds: float, traced: bool, device, t_import: float = T_IMPORT,
             program_cls=None, control: bool = False, frames: list | None = None) -> tuple[dict, list[str]]:
    """One run of ``cell``: (the result, the check lines). ``device`` is the
    card; the harness's tests pass the CPU and, to plant a fault,
    ``program_cls`` (``faults.py``): one class for every camera, or a list
    of one a camera. ``calibrate.py`` alone asks for ``control``, which
    adds the control's numbers and looks to the result under ``control``,
    and for ``frames``, which gathers each kept segment's frame table
    (``check.frames_row``).

    A configuration of several genlocked cameras (``cameras``) runs one
    ``Program`` a camera, each on its own CUDA stream: set-up makes and
    warms them one camera at a time, the window runs each camera's calls
    on a host thread of its own, the traced stretch replays on every
    camera's thread together under one profiler session, and the check
    replays each camera alone. At one camera all of it runs on this
    thread and the current stream."""
    import numpy as np
    import torch

    from ptzbench import check as checklib
    from ptzbench import program as proglib
    from ptzbench import trace as tracelib
    from ptzbench.generator import Traffic

    on_card = device.type == "cuda"
    config, mix = cell.config, cell.mix
    width, height, frontend = int(config["width"]), int(config["height"]), config["frontend"]
    n_cams = cameras_of(config)
    classes = list(program_cls) if isinstance(program_cls, (list, tuple)) else [program_cls] * n_cams
    if len(classes) != n_cams:
        raise ValueError(f"run: {len(classes)} program classes for {n_cams} cameras")
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
    cams = []
    for k in range(n_cams):
        traffic = Traffic(mix, seed, camera=k)
        cuda = torch.cuda.Stream(device) if on_card and n_cams > 1 else None
        cams.append(Camera(k, traffic, make_stream(traffic, width, height, device), cuda))
    phases["frames"] = time.perf_counter() - t
    pinned = sum(s.nbytes for cam in cams for s in cam.stream.stacks.values())
    t = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    for cam, cls in zip(cams, classes):
        with cam.on_stream():
            cam.fields = resolved_fields(config, cam.pose0)
            cam.prog = (cls or proglib.Program)(cam.fields, frontend, width, height, device)
            cam.state0, cam.carry0 = cam.prog.init(cam.img0, cam.pose0)
        if on_card:
            torch.cuda.synchronize(device)
    phases["init"] = time.perf_counter() - t
    t = time.perf_counter()
    for cam in cams:
        with cam.on_stream():
            cam.prog.warm_up(cam.state0, cam.carry0, cam.stream.frames([cam.traffic.warmup()]))
        if on_card:
            torch.cuda.synchronize(device)
        cam.counts0 = cam.prog.branch_counts()
    phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_import
    _log("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f"; total {setup_s:.3f}; "
         f"{n_cams} camera(s), frames pinned {pinned} bytes")

    # the window; the set-up's objects frozen out of the garbage collector's
    # reach, so that a full collection in the window stays short
    gc.collect()
    gc.freeze()
    chk = mix["check"]
    for cam in cams:
        rng = np.random.default_rng([int(seed), 29] + ([cam.k] if cam.k else []))
        cam.keeper = checklib.Keeper(chk["picks"], chk["segment_calls"], rng)
        cam.state, cam.carry = cam.state0, cam.carry0
        if mix["trace"]["from"] == "first":
            cam.trace_start = (0, cam.state0, cam.carry0)
    open_loop = mix["loop"] == "open"
    t0_clock = time.time()
    handed: list = []   # at several cameras in an open loop: how late the dispatcher handed over each call
    if n_cams == 1:
        cam = cams[0]
        t0 = time.perf_counter()
        for call in cam.traffic.calls():
            if open_loop:
                if call.due_s >= seconds:
                    break
                due = t0 + call.due_s
                while time.perf_counter() < due:   # spin: a sleep's wake-up comes late on a busy host
                    pass
            elif time.perf_counter() - t0 >= seconds:
                break
            cam.step(call, due if open_loop else None)
    else:
        t0, handed = window_on_threads(cams, device, seconds, open_loop)
    for cam in cams:
        cam.keeper.finish(cam.state)
    ends = [cam.t_end for cam in cams if cam.t_end is not None]
    wall = (max(ends) if ends else t0) - t0
    log = [entry for cam in cams for entry in cam.log]
    frames_done = sum(c.count for c, _ in log)
    attempted = sum(cam.attempted for cam in cams)
    failed = sum(cam.failed for cam in cams)
    counts = dict.fromkeys(proglib.BRANCHES, 0)
    for cam in cams:
        for k, v in cam.window_counts().items():
            counts[k] += v
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    walls_ms = [1e3 * w for _, w in log]
    _log(f"window: {frames_done} frames in {len(log)} calls, {wall:.4f} s; branches {counts}; "
         f"attempted {attempted}, failed {failed}, lost frames {sum(cam.lost for cam in cams)}; call walls ms p10 "
         f"{percentile(walls_ms, 10):.3f}, p50 {percentile(walls_ms, 50):.3f}, p90 {percentile(walls_ms, 90):.3f}, "
         f"max {max(walls_ms):.3f}")
    for cam in cams if n_cams > 1 else ():
        ms = [1e3 * w for _, w in cam.log]
        _log(f"window, camera {cam.k}: {sum(c.count for c, _ in cam.log)} frames in {len(cam.log)} calls; "
             f"branches {cam.window_counts()}; lost frames {cam.lost}; call walls ms p50 {percentile(ms, 50):.3f}, "
             f"p90 {percentile(ms, 90):.3f}, max {max(ms):.3f}")
    if not open_loop:   # each call's wall, beside the clock time the window opened (to read against the card's clocks)
        for cam in cams:
            named = f"camera {cam.k} " if n_cams > 1 else ""
            _log(f"{named}call walls ms from {t0_clock:.3f}: " + " ".join(f"{1e3 * w:.1f}" for _, w in cam.log))

    latencies = [x for cam in cams for x in cam.latencies]
    end_to_end = {
        "setup_s": setup_s,
        "fps": frames_done / wall if wall > 0 else math.nan,
        "latency_p95_ms": 1e3 * percentile(latencies, 95),
    }
    if open_loop:
        for cam in cams if n_cams > 1 else ():
            _log(f"latency ms, camera {cam.k}: {_latency(cam.latencies, cam.late)}")
        _log(f"latency ms: {_latency(latencies, [x for cam in cams for x in cam.late])}")
        if handed:
            _log(f"dispatcher late ms: p50 {1e3 * percentile(handed, 50)}, p99 {1e3 * percentile(handed, 99)}, "
                 f"max {1e3 * max(handed)} over {len(handed)} calls")

    result_device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    metrics: dict = {}
    breakdown = None
    if traced:
        with tracelib.session() as got:
            if n_cams == 1:
                cams[0].replay()
            else:
                on_threads(cams, device, Camera.replay)
        tr = got[0]
        replay = dict.fromkeys(proglib.BRANCHES, 0)
        for cam in cams:
            for k, v in cam.replayed.items():
                replay[k] += v
        flat = [(cam.stream, c.source, c.row + j) for cam in cams for c, _ in cam.stretch for j in range(c.count)]
        n = len(flat)

        def sample(k: int):
            picks = np.linspace(0, n - 1, k).round().astype(int)
            out = []
            for p in picks:
                stream, source, row = flat[p]
                prev_row = row - 1 if row > 0 else row
                out.append((stream.stacks[source][prev_row], stream.stacks[source][row], stream.poses[source][row]))
            return out

        view = View(
            trace=tr, frames=n, walls_s=[w for cam in cams for _, w in cam.stretch], branches=replay,
            window_branches=counts, window_frames=frames_done, kernels=dict(proglib.KERNELS), fields=cams[0].fields,
            frontend=frontend, width=width, height=height, sample=sample, cameras=n_cams,
        )
        for m in cell.per_layer:
            value = reg.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        busy = tracelib.busy_s(tr.device_ops)
        result_device["busy_s"] = busy
        result_device["window_s"] = tr.window_s
        breakdown = {"device_ops": tracelib.top_ops(tr.device_ops), "idle_gaps": tracelib.idle_gaps(tr)}
        calls = sum(len(cam.stretch) for cam in cams)
        starts = ", ".join(str(cam.trace_start[0] if cam.trace_start else 0) for cam in cams)
        ops_s = sum(o.dur_ns for o in tr.device_ops) / 1e9   # over busy_s where operations overlapped
        _log(f"trace: {n} frames in {calls} calls from call {starts}, {len(tr.device_ops)} device records, "
             f"busy {busy} s of {tr.window_s} s (operations {ops_s} s), branches {replay}")
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}

    # the check, after the programs and their graphs are freed
    gc.unfreeze()
    for cam in cams:
        cam.release()
    gc.collect()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    runs = [
        (checklib.Replay(cam.fields, frontend, width, height, cam.stream.frames, cam.img0, cam.pose0),
         cam.keeper.segments())
        for cam in cams
    ]
    t_check = time.perf_counter()
    numbers, rows, ctl = checklib.check_cameras(runs, device, control, frames)
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
