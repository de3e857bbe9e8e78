"""Kernel A's (``detect_kernel``) share of its roofline in the stretch's
replay: the bound of each launch at the cell's frame shape over the
launches' device time."""

from ptzbench import roofline, trace


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["harris_nms"])
    if not ops:
        return None
    work = roofline.harris_nms_work(view.height, view.width)
    return roofline.share_pct([work] * len(ops), sum(o.dur_ns for o in ops) / 1e9)
