"""Sequence / annotation I/O: datasets in, results out, host numpy. A
jax-free copy of ``ptzjax/io.py``.

Loads per-frame ground-truth (pan, tilt, focal) annotations and shared
intrinsics from .mat files (the reference dataset's layout, probed over a
small set of plausible key names) or from this project's own .npz layout,
fetches frame images (cv2, optional), builds detection masks from player
bounding boxes, and writes the per-frame JSONL log.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Sequence

import numpy as np

from ptzjax_torch.geometry import Intrinsics

try:  # host-side decode only; gated so the port runs without OpenCV
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


class SequenceAnnotations(NamedTuple):
    """Parsed sequence ground truth + shared camera constants.

    Attributes:
      cameras: (T, 3) fp32 GT (pan, tilt, focal); radians/pixels. Pan/tilt
        are converted from degrees if the source stores degrees (detected
        by magnitude: |pan| > pi anywhere means degrees).
      intr: shared Intrinsics (cx, cy, camera center, base rotation).
      image_names: optional per-frame file names (empty list if absent).
      bboxes: optional per-frame player boxes list of (N_i, 4) arrays
        (x1, y1, x2, y2) for mask building; None if absent.
    """

    cameras: np.ndarray
    intr: Intrinsics
    image_names: list
    bboxes: list | None


def _maybe_deg_to_rad(pan_tilt: np.ndarray) -> np.ndarray:
    """The reference dataset stores pan/tilt in degrees; ours store
    radians. Disambiguate by range: |pan| > pi anywhere => degrees."""
    if np.abs(pan_tilt).max() > np.pi:
        return np.deg2rad(pan_tilt)
    return pan_tilt


def _validate_cams(cams: np.ndarray, path: str) -> np.ndarray:
    """Fail loudly on malformed GT instead of tracking garbage."""
    cams = np.asarray(cams)
    if cams.ndim != 2 or cams.shape[1] != 3 or len(cams) == 0:
        raise ValueError(
            f"{path}: annotation must be a non-empty (T, 3) array of "
            f"(pan, tilt, focal); got shape {cams.shape}"
        )
    if not np.isfinite(cams).all():
        bad = np.flatnonzero(~np.isfinite(cams).all(axis=1))
        raise ValueError(
            f"{path}: non-finite camera values at frames {bad[:10].tolist()}"
        )
    if (cams[:, 2] <= 0).any():
        bad = np.flatnonzero(cams[:, 2] <= 0)
        raise ValueError(
            f"{path}: non-positive focal lengths at frames "
            f"{bad[:10].tolist()} — column order is (pan, tilt, focal)"
        )
    return cams


def load_annotations(path: str) -> SequenceAnnotations:
    """Load sequence annotations from .mat (reference layout) or .npz (ours)."""
    if path.endswith(".npz"):
        d = np.load(path, allow_pickle=True)
        missing = [k for k in ("cameras", "cx", "cy") if k not in d]
        if missing:
            raise ValueError(
                f"{path}: npz annotation missing keys {missing}; "
                f"found {sorted(d.files)}"
            )
        cams = _validate_cams(d["cameras"], path).astype(np.float32)
        intr = Intrinsics.create(
            float(d["cx"]), float(d["cy"]),
            center=d["center"] if "center" in d else None,
            base_rotation=d["base_rotation"] if "base_rotation" in d else None,
        )
        names = list(d["image_names"]) if "image_names" in d else []
        return SequenceAnnotations(cams, intr, names, None)

    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True, struct_as_record=False)

    def probe(*keys):
        for k in keys:
            if k in m:
                return m[k]
        return None

    ann = probe("annotation", "annotations", "ptz", "gt")
    meta = probe("meta", "camera", "shared")
    if ann is None:
        raise ValueError(
            f"no annotation key in {path}; found {sorted(k for k in m if not k.startswith('__'))}"
        )

    names: list = []
    bboxes = None
    if hasattr(ann, "__len__") and len(ann) and hasattr(ann[0], "_fieldnames"):
        # struct array: per-frame records with .ptz / .camera / .image_name
        cams = []
        bboxes = []
        for i, rec in enumerate(ann):
            ptz = getattr(rec, "ptz", getattr(rec, "camera", None))
            if ptz is None:
                raise ValueError(
                    f"{path}: frame record {i} has neither .ptz nor "
                    f".camera; fields: {rec._fieldnames}"
                )
            vals = np.asarray(ptz, np.float64).reshape(-1)
            if vals.size < 3:
                raise ValueError(
                    f"{path}: frame record {i} ptz has {vals.size} values; "
                    "need (pan, tilt, focal)"
                )
            cams.append(vals[:3])
            names.append(str(getattr(rec, "image_name", "")))
            bb = getattr(rec, "bounding_box", getattr(rec, "bbox", None))
            bboxes.append(
                np.asarray(bb, np.float32).reshape(-1, 4) if bb is not None
                else np.zeros((0, 4), np.float32)
            )
        cams = np.stack(cams)
    else:
        arr = np.asarray(ann, np.float64)
        if arr.ndim == 2 and arr.shape[1] != 3:
            # an explicit check: a (T, 2) array with T divisible by 3 would
            # otherwise silently reshape into garbage (pan, tilt, focal)
            raise ValueError(
                f"{path}: annotation array must be (T, 3); got {arr.shape}"
            )
        if arr.size == 0 or arr.size % 3:
            raise ValueError(
                f"{path}: annotation array has {arr.size} values, not a "
                "multiple of 3 (pan, tilt, focal per frame)"
            )
        cams = arr.reshape(-1, 3)

    cams = _validate_cams(cams, path)
    cams = np.concatenate(
        [_maybe_deg_to_rad(cams[:, :2]), cams[:, 2:3]], axis=1
    ).astype(np.float32)

    cx = cy = None
    center = base_rot = None
    if meta is not None and hasattr(meta, "_fieldnames"):
        cc = getattr(meta, "cc", getattr(meta, "principal_point", None))
        if cc is not None:
            cx, cy = np.asarray(cc, np.float64).reshape(-1)[:2]
        c = getattr(meta, "camera_center", getattr(meta, "cc_world", None))
        if c is not None:
            center = np.asarray(c, np.float32).reshape(3)
        r = getattr(meta, "base_rotation", getattr(meta, "rotation", None))
        if r is not None:
            r = np.asarray(r, np.float64).reshape(-1)
            if r.size == 9:
                base_rot = r.reshape(3, 3).astype(np.float32)
            elif r.size == 3:  # Rodrigues vector
                base_rot = _rodrigues(r).astype(np.float32)
    if cx is None:
        cx, cy = 640.0, 360.0  # 720p default; callers should override
    intr = Intrinsics.create(
        float(cx), float(cy), center=center, base_rotation=base_rot
    )
    return SequenceAnnotations(cams, intr, names, bboxes)


def _rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector -> matrix (some sequences store the base rotation as
    a Rodrigues vector)."""
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


def save_annotations_npz(
    path: str,
    cameras: np.ndarray,
    intr: Intrinsics,
    image_names: Sequence[str] = (),
) -> None:
    np.savez(
        path,
        cameras=np.asarray(cameras, np.float32),
        cx=float(intr.cx),
        cy=float(intr.cy),
        center=np.asarray(intr.center, np.float32),
        base_rotation=np.asarray(intr.base_rotation, np.float32),
        image_names=np.asarray(list(image_names)),
    )


def boxes_to_mask(
    bboxes: np.ndarray, height: int, width: int, dilate: int = 4
) -> np.ndarray:
    """(N, 4) player boxes -> (H, W) bool mask, True where detection is
    ALLOWED (keypoints inside player boxes are masked out)."""
    mask = np.ones((height, width), bool)
    arr = np.asarray(bboxes, np.float32)
    if arr.size % 4:
        raise ValueError(
            f"bounding boxes must be (N, 4) (x1, y1, x2, y2); got shape "
            f"{arr.shape}"
        )
    for x1, y1, x2, y2 in arr.reshape(-1, 4):
        xa = max(int(np.floor(x1)) - dilate, 0)
        ya = max(int(np.floor(y1)) - dilate, 0)
        xb = min(int(np.ceil(x2)) + dilate, width)
        yb = min(int(np.ceil(y2)) + dilate, height)
        mask[ya:yb, xa:xb] = False
    return mask


class SequenceManager:
    """Frames + GT + masks for one sequence (``get_image`` / ``get_ptz`` /
    ``get_mask`` / ``length``).

    Args:
      annotation_path: .mat or .npz annotation file.
      image_dir: directory of frame images (names from the annotation, or
        sorted directory listing as fallback).
    """

    def __init__(self, annotation_path: str, image_dir: str | None = None):
        self.ann = load_annotations(annotation_path)
        self.image_dir = image_dir
        self._files: list[str] = []
        if image_dir is not None:
            if self.ann.image_names:
                self._files = [
                    os.path.join(image_dir, n) for n in self.ann.image_names
                ]
            else:
                self._files = sorted(
                    os.path.join(image_dir, f)
                    for f in os.listdir(image_dir)
                    if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
                )

    @property
    def length(self) -> int:
        return len(self.ann.cameras)

    def get_ptz(self, i: int) -> np.ndarray:
        return self.ann.cameras[i]

    def get_image(self, i: int, gray: bool = True) -> np.ndarray:
        if not self._files:
            raise ValueError("no image_dir configured")
        if not _HAS_CV2:
            raise RuntimeError("cv2 unavailable for image decode")
        img = cv2.imread(self._files[i], cv2.IMREAD_GRAYSCALE if gray else 1)
        if img is None:
            raise FileNotFoundError(self._files[i])
        return (img.astype(np.float32) / 255.0) if gray else img

    def get_mask(self, i: int, height: int, width: int) -> np.ndarray | None:
        if self.ann.bboxes is None:
            return None
        return boxes_to_mask(self.ann.bboxes[i], height, width)


def write_trajectory_jsonl(path: str, records: Sequence[dict]) -> None:
    """Per-frame structured log: one JSON object per record, numpy arrays
    as lists."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps({
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in rec.items()
            }) + "\n")
