"""The host's part of a call: the mean wall of the stretch's calls in the
unprofiled window less the mean device busy time a call of their replay
under the profiler (the input copy, the state load, the launch, the one
read and the snapshot that the card does not cover)."""

from ptzbench import trace


def read(view):
    if not view.trace.device_ops or not view.walls_s:
        return None
    calls = len(view.walls_s)
    return 1e3 * (sum(view.walls_s) - trace.busy_s(view.trace.device_ops)) / calls
