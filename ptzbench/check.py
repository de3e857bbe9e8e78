"""What decides ``correct``: segments of the timed window replayed by the
plain reference (``reference/``), and the numbers that compare them.

During the window ``Keeper`` keeps a few segments, each a run of
consecutive calls (``segment_calls`` of them): the program's state and
KLT carry at the segment's start, its calls, the ``FrameInfo`` it returned
and its state at the end. Which segments, the mix names (``check.picks``):
"first", the window's first segment, which the reference runs from its own
bootstrap on frame 0; "last", the window's last, whose end state is the
stores the window left; "any", one drawn from the seed among all; and
"tag:<tag>", one drawn among those with a call of that tag. All but
"first" start from the program's state at the segment's start: the
reference follows the program from there, as the only way to check a
window of thousands of frames in a few seconds; the stores the segment
wrote are compared at its end, so that a store the program got wrong is
seen in the segment that wrote it.

Once the window has closed and the program is freed, ``check`` runs the
reference over each kept segment on the same frames and ``compare`` gives
the numbers, each the worst over the segments. A frame "tracked" on a side
is one it did not report lost and whose pose is finite; a segment's "calm
prefix" is its frames before the first that either side lost or
relocalized; its "locked prefix" is the calm prefix cut, after the first
``STEP_FRAMES`` frames, at the first frame whose innovation RMS in the
reference passes ``LOCK_PX``: where the reference itself has lost its lock
on the scene.

- ``step_gap_rad``: the largest pan or tilt difference over the segment's
  first ``STEP_FRAMES`` frames, infinite where a side lost one of them that
  the other tracked: steps from the same state, where only rounding parts
  the two sides;
- ``pose_gap_p50_rad``: the median pan or tilt difference over the locked
  prefix;
- ``bad_frame_pct``: the share of the segment's frames that are wrong on
  one side: tracked on one side only (anywhere in the segment, relocalized
  frames included), or, in the locked prefix, tracked on both with a pan
  or tilt difference over ``BAD_RAD``;
- ``kf_gap_rad``: the stores at the end of a segment in which neither side
  lost or relocalized a frame: the largest pan or tilt difference between
  the two sides' poses of the keyframes either side wrote in the segment
  (windowed BA moves them again), infinite where one side holds a keyframe
  there that the other does not; 0 for a segment with a loss.

The shared fp32 covariance update of the tracker (the program's and the
reference's alike) runs away now and then over some tens of frames before
a loss, and a runaway magnifies rounding; a relocalization then re-seeds
the tracker from a discrete solve (a focal-grid vote, an inlier set), and
in KLT mode a track's forward-backward test can flip. Two sound runs whose
rounding differs part there, by up to 0.09 rad, and their maps grow
apart. A lock can also fail on both sides at one frame, some tens of frames
before either reports it lost: the matches the update uses fall from ~245
to ~60 and the innovation RMS climbs from ~0.2 px to 2-5 px while the
focal jumps by a sixth; from there the two sides part by 1e-3 rad and
more, a rounding magnified, not a fault. Hence the poses are compared
only over the locked prefix, lost flags over the whole segment, and the
stores only where the segment had no loss. The ray store is printed as a
look (``_map_unmatched_pct``) with the largest gaps and the lost-flag
mismatches (see ``PERF.md``).

At several genlocked cameras (a configuration's ``cameras``) each camera
has its own ``Keeper`` and its own ``Replay``, and the reference replays
each camera's segments alone (``check_cameras``); each number is the worst
over all cameras' segments, under the cell's one ``limits`` file.

A cell compares the numbers its ``limits/<cell>.json`` names, each at or
under its limit; which, and the readings each limit was set from, are in
``PERF.md`` §2. The control, which ``calibrate.py`` runs and the
benchmark's runs do not, is the reference with TF32 on in the program's
place; ``faults.py`` holds the faults planted in the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ptzbench.reference import ekf as ref_ekf
from ptzbench.reference import loop as ref_loop
from ptzbench.reference import mapstore as ref_mapstore
from ptzbench.reference import slam as ref_slam

RAY_TOL = 1e-3     # radians: ~2 px at the cells' focal of 1,750-2,250 px
BAD_RAD = 5e-3     # radians: ~10 px, a pose a viewer sees off
STEP_FRAMES = 3    # a segment's first frames: steps from the same state
LOCK_PX = 0.75     # px: the reference's innovation RMS past which it has lost its lock
                   # (a tracked frame's is ~0.2, under 0.45 in 99.9 of 100)
NUMBERS = ("step_gap_rad", "pose_gap_p50_rad", "bad_frame_pct", "kf_gap_rad")
_REF_TYPES = {
    "SlamState": ref_slam.SlamState, "EKFState": ref_ekf.EKFState,
    "KeyframeStore": ref_mapstore.KeyframeStore, "RayStore": ref_mapstore.RayStore,
}


class Segment(NamedTuple):
    pick: str
    start: tuple | None        # the program's (state, carry) at the start; None: from init
    calls: list
    infos: list                # the program's FrameInfo of each call, on the host
    end: object                # the program's state at the end


class Keeper:
    """Keeps the mix's picks of the window's segments (see the module's
    docstring); ``rng`` draws the "any" and "tag:" picks by reservoir."""

    def __init__(self, picks, segment_calls: int, rng: np.random.Generator):
        self.picks = list(picks)
        self.segment_calls = int(segment_calls)
        self.rng = rng
        self.kept: dict[str, Segment] = {}
        self.seen: dict[str, int] = {}
        self.current: Segment | None = None

    def before(self, call, state, carry, first: bool) -> None:
        if self.current is None:
            self.current = Segment("", None if first else (state, carry), [], [], None)

    def after(self, call, infos, state) -> None:
        seg = self.current
        seg.calls.append(call)
        seg.infos.append(infos)
        if len(seg.calls) == self.segment_calls:
            self._close(seg._replace(end=state))

    def finish(self, state) -> None:
        """At the window's end: the segment under way closes as it is."""
        if self.current is not None and self.current.calls:
            self._close(self.current._replace(end=state))

    def _close(self, seg: Segment) -> None:
        self.current = None
        tags = {t for c in seg.calls for t in c.tags}
        for pick in self.picks:
            if pick == "first":
                if seg.start is None:
                    self.kept[pick] = seg._replace(pick=pick)
            elif pick == "last":
                self.kept[pick] = seg._replace(pick=pick)
            elif pick == "any" or (pick.startswith("tag:") and pick[4:] in tags):
                self.seen[pick] = self.seen.get(pick, 0) + 1
                if self.rng.random() * self.seen[pick] < 1.0:
                    self.kept[pick] = seg._replace(pick=pick)
            elif not pick.startswith("tag:"):
                raise ValueError(f"check: unknown pick {pick!r}")

    def segments(self) -> list[Segment]:
        """The kept segments, each once (a segment kept under two picks is
        replayed once)."""
        out, ids = [], set()
        for seg in self.kept.values():
            key = (seg.calls[0].first, len(seg.calls))
            if key not in ids:
                ids.add(key)
                out.append(seg)
        return out


def to_reference(tree):
    """A program's state (nested NamedTuples of tensors) as the reference's
    types, every tensor cloned."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _REF_TYPES[type(tree).__name__]
        return cls(*(to_reference(v) for v in tree))
    return tree.clone()


def _stack_infos(infos: list):
    """The FrameInfo of several calls as one, stacked over their frames."""
    return type(infos[0])(*(torch.cat(field) for field in zip(*infos)))


def _pan_tilt_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :2].double() - b[..., :2].double()).abs().amax(-1)


def _upper_median(values: torch.Tensor) -> float:
    """The upper median (the middle value, or the larger of the two middle
    ones), 0 for no values; an infinite value is a miss."""
    if values.numel() == 0:
        return 0.0
    return float(values.sort().values[values.numel() // 2])


def _touched(kf, start) -> torch.Tensor:
    """Keyframe rows that differ from the segment's start (validity, frame
    index or pose); every valid row where the segment starts at init."""
    valid = kf.valid.cpu()
    if start is None:
        return valid
    return (
        (valid != start.valid.cpu()) | (kf.frame_idx.cpu() != start.frame_idx.cpu())
        | (kf.poses.cpu() != start.poses.cpu()).any(-1)
    )


def kf_gap(prog_kf, ref_kf, start_kf=None) -> tuple[float, int]:
    """(the largest pan or tilt difference between the two stores' poses
    over the keyframe rows either side wrote since ``start_kf``, infinite
    where one side holds a valid row there that the other does not; the
    number of such one-sided rows)."""
    pv, rv = prog_kf.valid.cpu(), ref_kf.valid.cpu()
    touched = _touched(prog_kf, start_kf) | _touched(ref_kf, start_kf)
    both = pv & rv & touched
    miss = int(((pv ^ rv) & touched).sum())
    gaps = _pan_tilt_gap(prog_kf.poses.cpu()[both], ref_kf.poses.cpu()[both])
    if miss:
        return math.inf, miss
    return (float(gaps.max()) if gaps.numel() else 0.0), 0


def frame_table(prog_infos, ref_infos) -> dict:
    """Per frame of a segment, on the host: each side's tracked flag, the
    pan/tilt and relative focal differences (infinite where a side did not
    track the frame) and the frames that either side lost or relocalized."""
    pp, rp = prog_infos.pose.double().cpu(), ref_infos.pose.double().cpu()
    p_ok = ~prog_infos.lost.bool().cpu() & torch.isfinite(pp).all(-1)
    r_ok = ~ref_infos.lost.bool().cpu() & torch.isfinite(rp).all(-1)
    both = p_ok & r_ok
    n = len(pp)
    gap = torch.full((n,), math.inf, dtype=torch.float64)
    gap[both] = _pan_tilt_gap(pp[both], rp[both])
    focal = torch.full((n,), math.inf, dtype=torch.float64)
    focal[both] = (pp[both, 2] - rp[both, 2]).abs() / rp[both, 2].abs()
    event = ~p_ok | ~r_ok | (prog_infos.event.cpu() == 1) | (ref_infos.event.cpu() == 1)
    return {"p_ok": p_ok, "r_ok": r_ok, "gap": gap, "focal": focal, "event": event}


def locked_frames(ref_infos, calm: int) -> int:
    """The locked prefix's length: ``calm`` cut at the first frame after
    the first ``STEP_FRAMES`` whose innovation RMS in the reference (never
    the program's) passes ``LOCK_PX``."""
    over = ref_infos.innovation_rms.double().cpu() > LOCK_PX
    over[:STEP_FRAMES] = False
    return min(calm, int(over.to(torch.int64).argmax())) if over.any() else calm


def compare(prog_infos, ref_infos, prog_end, ref_end, start_kf=None) -> dict:
    """The numbers of one segment (see the module's docstring), and, under
    names that start with ``_``, what the look at a reading needs: the
    largest gaps, the frames whose lost flags differ, the calm prefix's
    length and the ray store's comparison."""
    t = frame_table(prog_infos, ref_infos)
    p_ok, r_ok, gap, focal, event = t["p_ok"], t["r_ok"], t["gap"], t["focal"], t["event"]
    both, one = p_ok & r_ok, p_ok ^ r_ok
    n = len(gap)
    calm = int(event.to(torch.int64).argmax()) if event.any() else n
    locked = locked_frames(ref_infos, calm)
    step = gap[:STEP_FRAMES][(p_ok | r_ok)[:STEP_FRAMES]]
    bad = one.clone()
    bad[:locked] |= gap[:locked] > BAD_RAD
    quiet = calm == n     # no loss or relocalization on either side
    kgap, kmiss = kf_gap(prog_end.kf, ref_end.kf, start_kf) if quiet else (0.0, 0)
    return {
        "step_gap_rad": float(step.max()) if step.numel() else 0.0,
        "pose_gap_p50_rad": _upper_median(gap[:locked]),
        "bad_frame_pct": 100.0 * int(bad.sum()) / max(n, 1),
        "kf_gap_rad": kgap,
        "_calm_frames": calm,
        "_locked_frames": locked,
        "_stores_compared": int(quiet),
        "_pose_gap_max_rad": float(gap[:calm].max()) if calm else 0.0,
        "_focal_gap_p50_rel": _upper_median(focal[:calm]),
        "_map_unmatched_pct": map_unmatched_pct(prog_end.rays, ref_end.rays) if quiet else 0.0,
        "_max_gap_rad": float(gap[both].max()) if both.any() else 0.0,
        "_max_focal_rel": float(focal[both].max()) if both.any() else 0.0,
        "_lost_mismatch": int(one.sum()),
        "_kf_valid_mismatch": kmiss,
    }


def map_unmatched_pct(a, b, tol: float = RAY_TOL) -> float:
    """100 x the valid rays of the stores ``a`` and ``b`` that have no valid
    ray of the other store within ``tol`` (the larger of the angle
    differences), over all valid rays of both."""
    ra = a.rays.to(torch.float64)[a.valid.to(a.rays.device)]
    rb = b.rays.to(device=a.rays.device, dtype=torch.float64)[b.valid.to(a.rays.device)]
    total = ra.shape[0] + rb.shape[0]
    if total == 0:
        return 0.0
    if ra.shape[0] == 0 or rb.shape[0] == 0:
        return 100.0
    d = (ra[:, None, :] - rb[None, :, :]).abs().amax(-1)
    miss = int((d.min(1).values > tol).sum()) + int((d.min(0).values > tol).sum())
    return 100.0 * miss / total


def worst_all(per_segment: list[dict]) -> dict:
    """The largest over the segments of every number and look (the keys
    that start with ``_``)."""
    keys = [k for k in per_segment[0] if k in NUMBERS or k.startswith("_")]
    return {k: max(s[k] for s in per_segment) for k in keys}


def worst(per_segment: list[dict]) -> dict:
    """Each number's worst (largest) over the segments."""
    return {name: max(s[name] for s in per_segment) for name in NUMBERS}


class Replay(NamedTuple):
    """What the reference needs of a run: its configuration, frames and
    frame 0."""

    fields: dict
    frontend: str
    width: int
    height: int
    frames_of: object    # calls -> (T, H, W) host frames
    img0: torch.Tensor
    pose0: np.ndarray


def run_reference(rp: Replay, seg: Segment, device, tf32: bool = False):
    """The reference over ``seg``'s frames from its start: (stacked
    FrameInfo, end state). The control is the same with ``tf32``."""
    cfg = ref_loop.make_config(rp.fields)
    intr = ref_loop.make_intrinsics(rp.width, rp.height)
    imgs = rp.frames_of(seg.calls).to(device)
    with ref_loop.precision(tf32), torch.no_grad():
        if seg.start is None:
            img0 = rp.img0.to(device)
            state, (xy, _, valid) = ref_loop.init(cfg, intr, img0, rp.pose0)
            carry = (img0, xy, valid)
        else:
            state, carry = seg.start
            state = to_reference(state)
            carry = tuple(torch.as_tensor(c).to(device) for c in carry)
        if rp.frontend == "klt":
            state, infos, _ = ref_loop.run_klt(state, imgs, carry, cfg, intr)
        else:
            state, infos = ref_loop.run_redetect(state, imgs, cfg, intr)
    return infos, state


def _row(seg: Segment, nums: dict) -> dict:
    return {"pick": seg.pick, "first": seg.calls[0].first, "frames": sum(c.count for c in seg.calls), **nums}


def frames_row(seg: Segment, side: str, prog_infos, ref_infos, prog_end, ref_end, start_kf) -> dict:
    """One segment's frame table and keyframe rows, as JSON for a look
    (``calibrate.py --frames``): per frame the tracked flags, the pan/tilt
    gap and the loss-or-relocalization flag; per keyframe row either side
    wrote, its pan/tilt gap (infinite where one side holds it alone)."""
    t = frame_table(prog_infos, ref_infos)
    pv, rv = prog_end.kf.valid.cpu(), ref_end.kf.valid.cpu()
    touched = _touched(prog_end.kf, start_kf) | _touched(ref_end.kf, start_kf)
    rows = []
    for i in torch.nonzero(touched).flatten().tolist():
        if pv[i] and rv[i]:
            rows.append(float(_pan_tilt_gap(prog_end.kf.poses.cpu()[i], ref_end.kf.poses.cpu()[i])))
        elif pv[i] or rv[i]:
            rows.append(math.inf)
    return {
        "pick": seg.pick, "first": seg.calls[0].first, "side": side,
        "p_ok": t["p_ok"].int().tolist(), "r_ok": t["r_ok"].int().tolist(),
        "gap": t["gap"].tolist(), "event": t["event"].int().tolist(), "kf": rows,
        "map_unmatched_pct": map_unmatched_pct(prog_end.rays, ref_end.rays),
    }


def check(rp: Replay, segments: list[Segment], device, control: bool = False,
          frames: list | None = None) -> tuple[dict, list[dict], dict | None]:
    """(the worst numbers, each segment's numbers with its pick and frames,
    and with ``control`` the control's worst numbers). The control is the
    reference with TF32 on in the program's place, from the same starts,
    judged by the same comparison; the benchmark's runs do not run it
    (``calibrate.py`` does, and passes ``frames`` for each segment's frame
    table)."""
    rows, ctl_rows = [], []
    for seg in segments:
        infos, end = run_reference(rp, seg, device)
        start_kf = None if seg.start is None else seg.start[0].kf
        prog = _stack_infos(seg.infos)
        rows.append(_row(seg, compare(prog, infos, seg.end, end, start_kf)))
        if frames is not None:
            frames.append(frames_row(seg, "program", prog, infos, seg.end, end, start_kf))
        if control:
            c_infos, c_end = run_reference(rp, seg, device, tf32=True)
            c_infos = type(c_infos)(*(v.cpu() for v in c_infos))
            ctl_rows.append(_row(seg, compare(c_infos, infos, c_end, end, start_kf)))
            if frames is not None:
                frames.append(frames_row(seg, "control", c_infos, infos, c_end, end, start_kf))
    return worst(rows), rows, (worst_all(ctl_rows) if control else None)


def check_cameras(runs: list, device, control: bool = False,
                  frames: list | None = None) -> tuple[dict, list[dict], dict | None]:
    """``check`` over every camera of a run, ``runs`` holding each camera's
    (``Replay``, kept segments): the reference replays each camera alone,
    one after another (the cameras share nothing, so camera k through the
    reference gives camera k's answers). Each number is the worst over all
    cameras' segments; at several cameras each segment's row and frame
    table names its camera."""
    numbers, rows, ctls = [], [], []
    for k, (rp, segments) in enumerate(runs):
        tables: list | None = None if frames is None else []
        nums, got, ctl = check(rp, segments, device, control, tables)
        tag = {"camera": k} if len(runs) > 1 else {}
        numbers.append(nums)
        rows += [{**tag, **r} for r in got]
        if frames is not None:
            frames += [{**tag, **r} for r in tables]
        if ctl is not None:
            ctls.append(ctl)
    worst_nums = {name: max(n[name] for n in numbers) for name in NUMBERS}
    return worst_nums, rows, ({k: max(c[k] for c in ctls) for k in ctls[0]} if ctls else None)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` (the cell's file) names: correct where each is finite and at
    or under its limit. A cell compares the numbers whose two readings its
    limits were set from (``PERF.md`` §2); a file that names none, or a
    number the check does not make, is refused."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"check: limits {sorted(limits)} must name some of {NUMBERS}")
    shown = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
