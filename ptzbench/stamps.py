"""The program's own stamps and host spans (``ptzjax_torch._trace``) of the
window's calls, for the per-layer metrics with source ``program_counter``
that read them (``metrics/*_ms*.py``). Beside ``program.py`` this is the
one module of the benchmark that imports the program: the readers' ``View``
holds no handle on it. A program without the stamps (a checkout from before
them) gives no records, and those metrics are left out of the result.

In a run, ``window()`` is the window's calls: the set-up's warm-up call,
which captured the frame graph, and the traced replay, which ran under the
profiler, are not in it. Times are nanoseconds on the host's clock, the
card's stamps moved onto it by the program's calibrated offset.
"""

from __future__ import annotations


def _trace():
    """``ptzjax_torch._trace``, or None where the program has none."""
    try:
        from ptzjax_torch import _trace
    except ImportError:
        return None
    return _trace


def window() -> list:
    """The window's call records (``_trace.Call``), oldest first."""
    t = _trace()
    return [] if t is None else t.window()


def _mean_ms(values: list):
    return 1e-6 * sum(values) / len(values) if values else None


def stage_ms(records: list, stamps: tuple, branches: tuple):
    """The device time of the stages that ``stamps`` end, summed over the
    records, a frame that took one of ``branches``, in ms."""
    t = _trace()
    if t is None or not records:
        return None
    frames = sum(r.counts[t.BRANCHES.index(b)] for r in records for b in branches)
    if not frames:
        return None
    return 1e-6 * sum(r.sums[t.INDEX[s]] for r in records for s in stamps) / frames


def frame_gap_ms(records: list):
    """The mean time from one frame graph's last stamp to the next one's
    first, between consecutive frames of a call, in ms."""
    return _mean_ms([r.rows[i + 2] - r.rows[i + 1] for r in records for i in range(0, len(r.rows) - 2, 2)])


def call_lead_ms(records: list):
    """The mean time from a call's entry to its first frame graph's first
    stamp, in ms."""
    t = _trace()
    return None if t is None else _mean_ms([r.rows[0] - r.host[t.ENTRY] for r in records if r.rows])


def call_tail_ms(records: list):
    """The mean time from a call's last frame graph's last stamp to the
    call's return, in ms (calls whose every frame has its row)."""
    t = _trace()
    if t is None:
        return None
    return _mean_ms([r.host[t.RETURN] - r.rows[-1] for r in records if r.rows and r.launched <= t.ROWS])
