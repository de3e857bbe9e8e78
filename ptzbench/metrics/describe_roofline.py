"""Kernel F's (``describe_kernel``) share of its roofline in the stretch's
replay. F's work depends on where the keypoints lie and on the zoom scale:
it is counted on frames sampled from the stretch, with the plain
reference's keypoints of each frame and the scale its focal gives, and
the mean taken as each launch's work."""

import torch

from ptzbench import roofline, trace
from ptzbench.reference.kernels.detect import detect_keypoints

SAMPLES = 4


def read(view):
    ops = trace.named(view.trace.device_ops, view.kernels["describe"])
    if not ops:
        return None
    f_ref = view.fields["descriptor_f_ref"]
    works = []
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for _, img, pose in view.sample(SAMPLES):
        img = torch.as_tensor(img, dtype=torch.float32).to(dev)
        kp = detect_keypoints(img, view.fields["max_keypoints"], view.fields["detector_threshold"])
        scale = None if f_ref <= 0 else torch.tensor(float(pose[2]) / f_ref)
        works.append(roofline.describe_work(img, kp.xy, kp.valid, scale))
    mean = tuple(sum(w[i] for w in works) / len(works) for i in range(2))
    return roofline.share_pct([mean] * len(ops), sum(o.dur_ns for o in ops) / 1e9)
