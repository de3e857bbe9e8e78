"""The share of the stretch's wall, in the unprofiled window, in which no
operation ran on the card: 1 - the stretch's device busy time (its replay
under the profiler) over the same calls' walls in the window."""

from ptzbench import trace


def read(view):
    wall = sum(view.walls_s)
    if not view.trace.device_ops or wall <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(view.trace.device_ops) / wall)
