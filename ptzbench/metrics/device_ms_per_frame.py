"""The card's busy time a frame: the union of the device records of the
stretch's replay under the profiler, over its frames, in ms."""

from ptzbench import trace


def read(view):
    if not view.trace.device_ops or view.frames <= 0:
        return None
    return 1e3 * trace.busy_s(view.trace.device_ops) / view.frames
