"""The device trace of a traced run: a ``torch.profiler`` session (CPU and
CUDA activities) over a replay of part of the window, read from the
profiler's raw records (building its event tree takes seconds for the
~1,000 records a frame), and what the metric readers and the result line
take from it."""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

PAD_S = 0.05   # the session stays open this long around the work: without it
               # the profiler now and then hands back only part of the records


class Op(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    device_ops: list      # Op of each device record (kernels, copies, sets)
    host_ops: list        # Op of each host record
    window_s: float       # the traced window's wall (the replay's)


def short(name: str) -> str:
    """A kernel's name without its argument list and a leading ``void``;
    copies and sets keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name.strip()
    return name[5:] if name.startswith("void ") else name


@contextlib.contextmanager
def session():
    """A profiler session; yields a list that holds the ``Trace`` once the
    session has closed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        yield out
        if card:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        time.sleep(PAD_S)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns(), e.duration_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(op)
    out.append(Trace(dev, host, window))


def is_kernel(op: Op) -> bool:
    return not op.name.startswith(("Memcpy", "Memset"))


def busy_intervals(ops: list) -> list[tuple[int, int]]:
    """The union of the ops' [start, end) intervals, merged, in order."""
    spans = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in ops)
    merged: list[list[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(ops: list) -> float:
    return sum(e - s for s, e in busy_intervals(ops)) / 1e9


def top_ops(ops: list, n: int = 10) -> list:
    """[[kernel name, seconds]] of the ``n`` names with the most device time."""
    by: dict = {}
    for o in ops:
        k = short(o.name)
        by[k] = by.get(k, 0) + o.dur_ns
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[[what the host was doing, seconds]]: the idle gaps between the
    device's busy intervals, each named by the innermost host record open
    at its midpoint (the latest to start), summed by that name, the ``n``
    largest."""
    busy = busy_intervals(tr.device_ops)
    host = sorted(tr.host_ops, key=lambda o: o.start_ns)
    by: dict = {}
    opened: list = []   # host records started by the midpoint, latest last
    k = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        while k < len(host) and host[k].start_ns <= mid:
            opened.append(host[k])
            k += 1
        while opened and opened[-1].start_ns + opened[-1].dur_ns < mid:
            opened.pop()
        label = opened[-1].name if opened else "no host record"
        by[label] = by.get(label, 0) + (s1 - e0)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def base(name: str) -> str:
    """A kernel's bare name: ``short`` without template arguments and
    namespaces (``void {anonymous}::detect_kernel<4>(...)`` -> ``detect_kernel``)."""
    return short(name).split("<", 1)[0].rsplit("::", 1)[-1]


def named(ops: list, kernel: str) -> list:
    """The records of the kernel whose bare name is ``kernel``."""
    return [o for o in ops if base(o.name) == kernel]
