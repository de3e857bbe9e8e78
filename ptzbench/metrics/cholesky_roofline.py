"""Kernel D's (``cholesky_cluster``) share of its roofline in the
stretch's replay: one factor of the EKF's innovation matrix, n = 2 x the
ray slots, a tracked frame. The launches must number the tracked frames,
else nothing is read."""

from ptzbench import roofline, trace


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["cholesky"])
    if not ops or len(ops) != view.branches.get("track", 0):
        return None
    work = roofline.cholesky_work(2 * view.fields["max_rays"])
    return roofline.share_pct([work] * len(ops), sum(o.dur_ns for o in ops) / 1e9)
