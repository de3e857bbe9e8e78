"""Kernel C's (``match_kernel``) share of its roofline in the stretch's
replay, each launch at its own shape: a frame's "track" branch matches its
keypoints against the EKF's slots (gated, mutual); an insert frame takes
"track" and then "insert+ba" or "insert" (the branch counts hold it under
both), whose keyframe match launches C again against the same slots; a
lost frame matches against the map's rays ("map" relocalization, mutual).
So the launches number "track" + "insert+ba" + "insert" + "lost", else
nothing is read."""

from ptzbench import roofline, trace


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["match"])
    f, b = view.fields, view.branches
    if not ops or f["reloc_mode"] != "map":
        return None
    q, d = f["max_keypoints"], f["kf_desc_dim"]
    slots = b.get("track", 0) + b.get("insert+ba", 0) + b.get("insert", 0)
    if len(ops) != slots + b.get("lost", 0):
        return None
    works = [roofline.match_work(q, f["max_rays"], d, gated=True, mutual=True)] * slots
    works += [roofline.match_work(q, f["max_map_rays"], d, gated=False, mutual=True)] * b.get("lost", 0)
    return roofline.share_pct(works, sum(o.dur_ns for o in ops) / 1e9)
