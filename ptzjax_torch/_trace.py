"""Stamps and spans of the graph route (``_graphs.py``), kept in memory:
where a frame's device time goes, stage by stage, and what the host was
doing while the card ran no frame graph.

**Device stamps.** A ``TrackGraph`` owns one int64 stats buffer (layout
below). Its frame program stamps the frame's boundaries into it: a one-thread
kernel of ``csrc/graph_cond.cu`` (one kernel name a stamp,
``stamp_track_predict`` ...) reads the card's nanosecond clock, adds the time
since the last stamp to the stage the stamp ends, and keeps each frame's
first and last stamp in a row. The stamps of a branch are captured with it;
the frame's first and last are nodes of the frame graph around its IF nodes.
A branch's last stamp also counts the frame into the branch's entry (which
``TrackGraph.taken`` views). ``stamp(stage)`` does nothing unless a
``TrackGraph`` branch has made its buffer the target (``into``), so the eager
route is unchanged; on the CPU, where the graph loop runs its frame program
eagerly in the tests, it writes ``time.time_ns()`` into the same buffer.

**Host spans.** Each call of ``_graphs.Runner`` takes a record from a
bounded ring (``begin``) and writes ``time.time_ns()`` at its parts' bounds
(``Call``): the copy of the frames to the card, the load of the state, each
frame's fill, launch and info copy, the call's one read (``finish``, where
the host waits for the card), the snapshot of the state and the stack of the
infos. The read adds the call's device stamps, moved onto the same clock.

**One clock.** ``time.time_ns()`` is the clock of the profiler's host
records. ``calibrate`` brackets a few "clock" stamps between two reads of
it around a synchronize, once a device and again where a profiler session
begins or ends (``follow``): the narrowest bracket bounds the offset
between the clocks (``Clock``, 10-25 us wide). The two clocks drift
apart by a few parts per million (0.04-0.57 ms over a benchmark run on
the H100), so each call's stamps keep the bounds up to date (``bound``): a
"clock" stamp just before the call's read bounds the offset above (the
host reads it back after it ran), and one launched just after it, onto the
idle card, bounds it below (it ran after its launch; the next call's read
brings it back). A host slowed after a long wait only loosens a bound,
never moves it past the truth. Device stamps, moved by the middle of the
bounds, and host spans then compare directly, and with a profiled
trace.

``window()`` gives the ring's complete calls that captured no graph and ran
under no profiler session; ``gaps(records)`` puts the card's time between
frame graphs down to the host span open at each interval's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

from ptzjax_torch.kernels import _build

# the branches of the frame program, in the order of their counts
BRANCHES = ("lost", "track", "insert+ba", "insert")

# the stamps, in the order of csrc/graph_cond.cu's PTZ_STAMPS; each ends the
# stage it names (the time since the stamp before), but "frame.start", which
# opens the frame's row, and "clock", which only keeps the card's time (in
# LAST) for the bounds on the clocks' offset; "frame.end" ends the stage of the
# conditional nodes after the frame's last branch and closes the row. A
# branch's "tail" stamp counts the frame into the branch.
STAMPS = (
    "frame.start",
    "track.frontend", "track.predict", "track.association", "track.update", "track.map", "track.tail",
    "insert+ba.keyframe", "insert+ba.merge", "insert+ba.ba", "insert+ba.tail",
    "insert.keyframe", "insert.merge", "insert.tail",
    "lost.frontend", "lost.reloc", "lost.tail",
    "frame.end", "clock",
)
INDEX = {name: k for k, name in enumerate(STAMPS)}
TAILS = {INDEX[f"{b}.tail"]: k for k, b in enumerate(BRANCHES)}
OPEN, CLOSE, CLOCK = INDEX["frame.start"], INDEX["frame.end"], INDEX["clock"]

# the stats buffer (int64), as csrc/graph_cond.cu lays it out: [0, 4) the
# frames that took each branch; LAST the last stamp; ROW the frames stamped
# since the buffer was zeroed; SUM0 + k the nanoseconds of the stage that
# stamp k ends; from ROW0 each frame's (first, last) stamp, for the first
# ROWS frames of a call
LAST, ROW, SUM0 = 4, 5, 6
ROW0 = SUM0 + len(STAMPS)
ROWS = 256
SIZE = ROW0 + 2 * ROWS

# a call's host marks: its entry (the copy's start), the copy's end (the
# load's start), the load's end, the read's start (the last frame's info
# copy's end), the read's end (the snapshot's start), the snapshot's end
# (the stack's start) and the return; a frame's three: fill, launch and
# info copy, each the previous part's end
ENTRY, COPIED, LOADED, FINISH, READ, SNAPPED, RETURN = range(7)
FRAME_PARTS = ("fill", "launch", "clone_info")

CALLS = 4096   # the ring's records: the last this many calls


def buffer(device) -> torch.Tensor:
    """A zeroed stats buffer."""
    return torch.zeros(SIZE, dtype=torch.int64, device=device)


_target: tuple | None = None   # (stats buffer, branch) of the branch being run


@contextlib.contextmanager
def into(stats: torch.Tensor, branch: str):
    """Within the block, ``stamp(stage)`` stamps ``{branch}.{stage}`` into
    ``stats``: what a ``TrackGraph`` branch runs (and its graph captures)."""
    global _target
    outer, _target = _target, (stats, branch)
    try:
        yield
    finally:
        _target = outer


def stamp(stage: str) -> None:
    """The end of ``stage`` of the branch being run, where a ``TrackGraph``
    branch has made its buffer the target; nothing elsewhere."""
    if _target is not None:
        write(_target[0], f"{_target[1]}.{stage}")


def write(stats: torch.Tensor, name: str) -> None:
    """The stamp ``name`` into ``stats``: on the card a launch of its kernel
    on the current stream (or a node of the capture), on the CPU at once."""
    k = INDEX[name]
    if stats.is_cuda:
        stream = torch.cuda.current_stream(stats.device).cuda_stream
        _build.check(_build.load().ptz_stamp(k, stats.data_ptr(), stream), f"the stamp {name!r}")
    else:
        _host_stamp(stats.numpy(), k, time.time_ns())


def _host_stamp(s, k: int, now: int) -> None:
    """``csrc/graph_cond.cu``'s ``stamp_at`` on a host array."""
    if k != CLOCK:
        row = int(s[ROW])
        if k == OPEN:
            if row < ROWS:
                s[ROW0 + 2 * row] = now
        else:
            s[SUM0 + k] += now - s[LAST]
        if k in TAILS:
            s[TAILS[k]] += 1
        if k == CLOSE:
            if row < ROWS:
                s[ROW0 + 2 * row + 1] = now
            s[ROW] = row + 1
    s[LAST] = now


DRIFT_PPM = 20   # how fast a bound on the offset ages: the two clocks drift apart by 3-8 ppm on the H100


class Clock:
    """What the host knows of a card's clock: the offset (host clock minus
    the card's, ns) lies between ``lo`` and ``hi``, hard bounds taken at the
    host's times ``t_lo`` and ``t_hi``, each loosening by ``DRIFT_PPM`` as it
    ages. A new bound replaces the old one where it is tighter; one that
    crosses the other bound (a drift faster than allowed for) replaces that
    too. ``profiled``: whether a profiler session was open when the clock
    was calibrated."""

    __slots__ = ("lo", "t_lo", "hi", "t_hi", "profiled")

    def __init__(self, lo: int, hi: int, at: int, profiled: bool = False):
        self.lo, self.hi, self.t_lo, self.t_hi, self.profiled = lo, hi, at, at, profiled

    def bounds(self, at: int) -> tuple[int, int]:
        return (self.lo - (at - self.t_lo) * DRIFT_PPM // 10**6, self.hi + (at - self.t_hi) * DRIFT_PPM // 10**6)

    def above(self, value: int, at: int) -> None:
        """The offset is at least ``value`` (a stamp launched at ``at``)."""
        lo, hi = self.bounds(at)
        if value >= lo:
            self.lo, self.t_lo = value, at
        if value > hi:
            self.hi, self.t_hi = value, at

    def below(self, value: int, at: int) -> None:
        """The offset is at most ``value`` (a stamp read back at ``at``)."""
        lo, hi = self.bounds(at)
        if value <= hi:
            self.hi, self.t_hi = value, at
        if value < lo:
            self.lo, self.t_lo = value, at

    def offset(self, at: int) -> int:
        lo, hi = self.bounds(at)
        return (lo + hi) // 2


_clocks: dict = {}   # device index -> Clock


def calibrate(device, tries: int = 16) -> None:
    """The offset from the card's clock to ``time.time_ns()``, measured
    once a device (again after a profiler session begins or ends:
    ``follow``): ``tries`` "clock" stamps, each launched onto the idle card
    and synchronized between two host reads; the narrowest bracket bounds
    the offset (10-25 us wide). The calls' own stamps keep the bounds up to
    date (``bound``)."""
    device = torch.device(device)
    if device.index not in _clocks:
        scratch = buffer(device)
        best = None
        for _ in range(tries):
            torch.cuda.synchronize(device)
            h0 = time.time_ns()
            write(scratch, "clock")
            torch.cuda.synchronize(device)
            h1 = time.time_ns()
            t = int(scratch[LAST])
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0 - t, h1 - t, h1)
        _clocks[device.index] = Clock(*best, torch.autograd._profiler_enabled())


def follow(device: torch.device, profiled: bool) -> bool:
    """Calibrate the clock of ``device`` (a tensor's) anew where a
    profiler session has begun or ended since its calibration: starting one
    moves the card's clock against the host's (by ~0.06 ms on the H100), so
    the bounds taken before it no longer hold. Returns whether it did (the
    first call after a session's start or end then reads the card a few
    more times); nothing on the CPU."""
    clock = _clocks.get(device.index) if device.type == "cuda" else None
    if clock is None or clock.profiled == profiled:
        return False
    del _clocks[device.index]
    calibrate(device)
    return True


def bound(device: torch.device, launched: tuple | None, returned: tuple | None) -> None:
    """New bounds on the offset of ``device`` (a tensor's): ``launched``, a
    "clock" stamp launched onto the idle card (host time before the launch,
    stamp), bounds it below; ``returned``, a stamp the host read back (stamp,
    host time after the read), above. Nothing on the CPU or before a
    calibration."""
    clock = _clocks.get(device.index) if device.type == "cuda" else None
    if clock is not None:
        if launched is not None:
            clock.above(launched[0] - launched[1], launched[0])
        if returned is not None:
            clock.below(returned[1] - returned[0], returned[1])


def offset(device: torch.device, at: int) -> int:
    """The offset of ``device`` (a tensor's) at the host's time ``at``: the
    middle of its bounds; 0 on the CPU, whose stamps are host reads, and
    before a calibration."""
    clock = _clocks.get(device.index) if device.type == "cuda" else None
    return 0 if clock is None else clock.offset(at)


class Call:
    """One call of ``_graphs.Runner``: its frontend ``kind``, its ``frames``
    (``launched`` of them launched a frame graph), whether it ``captured``
    the frame graph or ran under a profiler session (``profiled``), the host
    marks ``host`` (``ENTRY`` ... ``RETURN``) and ``marks`` (three a frame,
    ``FRAME_PARTS``' starts), all ``time.time_ns()``; from the call's read,
    the branch ``counts``, the stage ``sums`` (ns, by stamp) and ``rows``,
    each launched frame's first and last stamp on the host's clock (the
    first ``ROWS`` frames), moved by ``offset``."""

    __slots__ = (
        "kind", "frames", "launched", "captured", "profiled", "host", "marks", "counts", "sums", "rows", "offset",
    )

    def __init__(self):
        self.host = [0] * 7
        self.marks: list = []
        self.kind, self.frames, self.launched = "", 0, 0
        self.captured = self.profiled = False
        self.counts: list = []
        self.sums: list = []
        self.rows: list = []
        self.offset = 0

    def mark(self, at: int) -> None:
        self.host[at] = time.time_ns()

    def read(self, stats: list, offset_ns: int) -> None:
        """The call's device part from the used prefix of its stats buffer,
        read on the host, the stamps moved by ``offset_ns`` onto the host's
        clock."""
        self.offset = offset_ns
        self.counts = stats[:len(BRANCHES)]
        self.sums = stats[SUM0:ROW0]
        self.rows = [v + offset_ns for v in stats[ROW0:ROW0 + 2 * min(self.launched, ROWS)]]

    def complete(self) -> bool:
        return self.host[RETURN] > 0

    def spans(self) -> list:
        """(start, end, part) of each host part, in order."""
        h, m = self.host, self.marks
        out = [(h[ENTRY], h[COPIED], "copy_in"), (h[COPIED], h[LOADED], "load")]
        ends = m[1:3 * self.frames] + [h[FINISH]]
        for i in range(3 * self.frames):
            out.append((m[i], ends[i], FRAME_PARTS[i % 3]))
        out += [(h[FINISH], h[READ], "finish"), (h[READ], h[SNAPPED], "snapshot"), (h[SNAPPED], h[RETURN], "stack")]
        return out


class Ring:
    """The last ``size`` calls' records, made once and reused."""

    def __init__(self, size: int = CALLS):
        self.calls = [Call() for _ in range(size)]
        self.next = 0     # calls begun

    def begin(self, kind: str, frames: int) -> Call:
        """The record of a call that starts now."""
        rec = self.calls[self.next % len(self.calls)]
        self.next += 1
        rec.kind, rec.frames, rec.launched, rec.captured = kind, frames, 0, False
        rec.profiled = torch.autograd._profiler_enabled()
        if len(rec.marks) < 3 * frames:
            rec.marks = [0] * (3 * frames)
        rec.host[RETURN] = 0
        rec.mark(ENTRY)
        return rec

    def records(self) -> list:
        """The complete records, oldest first."""
        n = len(self.calls)
        order = self.calls[self.next % n:] + self.calls[:self.next % n] if self.next >= n else self.calls[:self.next]
        return [r for r in order if r.complete()]


RING = Ring()


def begin(kind: str, frames: int) -> Call:
    return RING.begin(kind, frames)


def window(ring: Ring | None = None) -> list:
    """The ring's complete calls, oldest first, that captured no graph and
    ran under no profiler session: in a benchmark run, its window's calls."""
    return [r for r in (ring or RING).records() if not (r.captured or r.profiled)]


def gaps(records) -> dict:
    """ns of the card's time between frame graphs (between one frame's last
    stamp and the next one's first, within and between the calls
    ``records``, in order), each interval put down to the host part open at
    its midpoint (``Call.spans``), or "caller" where none is. The card may
    run the call's frame copy or info copies there; no frame graph runs."""
    busy = sorted(
        (r.rows[i], r.rows[i + 1]) for r in records for i in range(0, len(r.rows), 2)
    )
    spans = sorted(s for r in records for s in r.spans())
    starts = [s for s, _, _ in spans]
    out: dict = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 <= e0:
            continue
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        part = spans[i][2] if i >= 0 and spans[i][0] <= mid < spans[i][1] else "caller"
        out[part] = out.get(part, 0) + s1 - e0
    return out
