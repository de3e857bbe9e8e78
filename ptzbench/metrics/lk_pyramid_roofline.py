"""Kernel E's pyramid launch's (``pyramid_kernel``) share of its roofline
in the stretch's replay: each launch builds levels 1.. of a frame pair at
the cell's shape."""

from ptzbench import roofline, trace


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["lk_pyramid"])
    if not ops:
        return None
    work = roofline.pyramid_work(view.height, view.width, view.fields["flow_levels"], 2)
    return roofline.share_pct([work] * len(ops), sum(o.dur_ns for o in ops) / 1e9)
