"""Kernel launches a frame: the kernel records (not copies or sets) of the
stretch's replay under the profiler, over its frames."""

from ptzbench import trace


def read(view):
    kernels = [o for o in view.trace.device_ops if trace.is_kernel(o)]
    if not kernels or view.frames <= 0:
        return None
    return len(kernels) / view.frames
