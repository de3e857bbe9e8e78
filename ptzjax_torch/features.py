"""Frame feature containers + the synthetic feature adapter, host numpy. A
jax-free copy of ``ptzjax/features.py`` (same seeds, bitwise the same
tables).

``FrameFeatures`` is the fixed-capacity interface between a feature source
(the port's detect/describe, OpenCV ingestion, or the synthetic oracle) and
the SLAM loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ptzjax_torch.synth import SyntheticSequence, render_frame


class FrameFeatures(NamedTuple):
    """Padded per-frame features.

    Attributes:
      xy: (F, 2) fp32 keypoint pixel positions.
      desc: (F, D) fp32 descriptors (unit norm by convention).
      valid: (F,) bool.
    """

    xy: np.ndarray
    desc: np.ndarray
    valid: np.ndarray

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def synth_features(
    seq: SyntheticSequence,
    frame: int,
    capacity: int,
    noise_px: float = 0.5,
    desc_noise: float = 0.05,
    outlier_frac: float = 0.0,
    dropout_frac: float = 0.0,
    seed: int = 0,
) -> tuple[FrameFeatures, np.ndarray]:
    """Render a synthetic frame to FrameFeatures.

    Descriptors are the per-ray GT descriptors plus observation noise,
    re-normalized — matching across frames behaves like real descriptors
    with a controllable difficulty knob.

    Returns:
      (features, gt_ray_ids): gt_ray_ids (F,) int32, -1 where invalid —
      ground-truth association for evaluating the matcher, never given to
      the SLAM loop.
    """
    rng = np.random.default_rng((seed + 13) * 7919 + frame)
    pix, _, ids = render_frame(
        seq, frame, noise_px=noise_px, outlier_frac=outlier_frac,
        dropout_frac=dropout_frac, seed=seed,
    )
    n = min(len(ids), capacity)
    if len(ids) > capacity:
        # real detectors return response-ranked keypoints: the same salient
        # corners show up frame after frame. Emulate with a deterministic
        # per-ray salience (hash of the ray id) — an independent random
        # subsample per frame would make half the tracked features vanish
        # every frame, which no real detector does.
        salience = np.modf(np.sin(ids.astype(np.float64) * 12.9898) * 43758.5453)[0]
        sel = np.argsort(salience)[-capacity:]
        sel.sort()
        pix, ids = pix[sel], ids[sel]
    xy = np.zeros((capacity, 2), np.float32)
    desc = np.zeros((capacity, seq.descriptors.shape[1]), np.float32)
    valid = np.zeros((capacity,), bool)
    gt_ids = np.full((capacity,), -1, np.int32)
    xy[:n] = pix[:n]
    d = seq.descriptors[ids[:n]] + desc_noise * rng.normal(
        size=(n, seq.descriptors.shape[1])
    ).astype(np.float32)
    desc[:n] = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    valid[:n] = True
    gt_ids[:n] = ids[:n]
    return FrameFeatures(xy=xy, desc=desc, valid=valid), gt_ids
