"""Trajectory / error plots for a run, host numpy and matplotlib. A jax-free
copy of ``ptzjax/plots.py``: one figure with the estimated vs ground-truth
trajectory per parameter and the absolute error curves, with lost /
relocalization / keyframe events marked.

Matplotlib is an optional dependency: it is imported only when a plot is
actually requested (the SLAM loop itself never imports this module).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

# categorical slots: estimate=blue, error=orange; GT is a neutral reference
# line; red is reserved for the lost/reloc status
_EST = "#2a78d6"
_ERR = "#eb6834"
_GT = "#6b6b6b"
_LOST = "#e34948"
_KF = "#1baf7a"
_GRID = dict(color="#d9d9d4", linewidth=0.6)

_ROWS = (
    ("pan", "pan (deg)", np.rad2deg, "|pan error| (deg)"),
    ("tilt", "tilt (deg)", np.rad2deg, "|tilt error| (deg)"),
    ("focal", "focal (px)", lambda x: x, "|focal error| (px)"),
)


def plot_run(
    pose: np.ndarray,
    gt: np.ndarray | None,
    out_path: str,
    records: Sequence[dict[str, Any]] | None = None,
    frame0: int = 1,
    title: str | None = None,
) -> str:
    """Write the run-summary figure: 3 rows (pan, tilt, focal) x 2 columns
    (trajectory vs GT, absolute error), event markers from ``records``.

    Args:
      pose: (T, 3) estimated (pan, tilt, f) per frame, radians/pixels.
      gt: (T, 3) ground truth, or None (trajectory-only plot).
      records: optional per-frame dicts from the run loop ("lost",
        "keyframe", "event" keys mark events on the time axis).
      frame0: frame index of pose[0] (the loop starts at frame 1).

    Returns:
      out_path.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pose = np.asarray(pose, np.float64)
    t = np.arange(frame0, frame0 + len(pose))
    have_gt = gt is not None
    if have_gt:
        gt = np.asarray(gt, np.float64)[: len(pose)]

    ncols = 2 if have_gt else 1
    fig, axes = plt.subplots(
        3, ncols, figsize=(6.0 * ncols, 7.5), sharex=True, squeeze=False
    )

    lost_t = kf_t = None
    if records is not None:
        lost_t = [r["frame"] for r in records if r.get("lost")]
        kf_t = [r["frame"] for r in records if r.get("keyframe")]

    for i, (_, ylabel, conv, err_label) in enumerate(_ROWS):
        ax = axes[i][0]
        if have_gt:
            ax.plot(
                t, conv(gt[:, i]), color=_GT, linewidth=1.4,
                linestyle=(0, (4, 3)), label="ground truth",
            )
        ax.plot(t, conv(pose[:, i]), color=_EST, linewidth=1.6, label="estimate")
        ax.set_ylabel(ylabel)
        ax.grid(True, **_GRID)
        for spine in ("top", "right"):
            ax.spines[spine].set_visible(False)
        if i == 0:
            ax.legend(loc="best", frameon=False, fontsize=9)

        if have_gt:
            axe = axes[i][1]
            axe.plot(
                t, np.abs(conv(pose[:, i]) - conv(gt[:, i])),
                color=_ERR, linewidth=1.6, label="abs error",
            )
            axe.set_ylabel(err_label)
            axe.set_yscale("log")
            axe.grid(True, **_GRID)
            for spine in ("top", "right"):
                axe.spines[spine].set_visible(False)

        for ax_ in axes[i]:
            if lost_t:
                for j, x in enumerate(lost_t):
                    ax_.axvline(
                        x, color=_LOST, alpha=0.35, linewidth=1.0,
                        label="lost/reloc" if (i == 0 and j == 0) else None,
                    )
            if kf_t:
                for j, x in enumerate(kf_t):
                    ax_.axvline(
                        x, color=_KF, alpha=0.3, linewidth=0.8,
                        linestyle=(0, (1, 2)),
                        label="keyframe" if (i == 0 and j == 0) else None,
                    )
        if i == 0 and (lost_t or kf_t):
            axes[0][0].legend(loc="best", frameon=False, fontsize=9)

    for ax in axes[-1]:
        ax.set_xlabel("frame")
    if title:
        fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path
