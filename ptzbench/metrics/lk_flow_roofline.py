"""Kernel E's LK launch's (``lk_flow_kernel``) share of its roofline in the
stretch's replay. Its work depends on the keypoints and the motion: it is
counted on frame pairs sampled from the stretch, the table being the
plain reference's detections on the earlier frame and the steps the
plain LK's own, and the mean taken as each launch's work."""

import torch

from ptzbench import roofline, trace
from ptzbench.reference.kernels.detect import detect_keypoints
from ptzbench.reference.kernels.flow import build_pyramid_plain

SAMPLES = 4


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["lk_flow"])
    if not ops:
        return None
    f = view.fields
    opts = dict(
        patch=f["flow_patch"], iters=f["flow_iters"], min_eig=1e-3, max_residual=0.5, fb_check=True,
        border=2.0,
    )
    works = []
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for prev, img, _ in view.sample(SAMPLES):
        prev, img = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (prev, img))
        kp = detect_keypoints(prev, f["max_keypoints"], f["detector_threshold"])
        pyrs = [build_pyramid_plain(x, f["flow_levels"]) for x in (prev, img)]
        works.append(roofline.lk_work(pyrs[0], pyrs[1], kp.xy, kp.valid, **opts))
    mean = tuple(sum(w[i] for w in works) / len(works) for i in range(2))
    return roofline.share_pct([mean] * len(ops), sum(o.dur_ns for o in ops) / 1e9)
