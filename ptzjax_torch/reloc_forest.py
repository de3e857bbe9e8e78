"""ctypes bridge to the native C++ relocalization forest, and forest-backed
relocalization. Port of ``ptzjax/reloc_forest.py``.

Descriptors go down to the BTDTR forest of ``cpp/reloc_forest`` (the
reference's own native component, shared with ``ptzjax``), predicted rays
come back as host numpy, and the 3-DoF pose is solved on the caller's
device by the same vote + refine pipeline as map relocalization
(``reloc.solve_from_correspondences``), so the two are interchangeable
backends behind one result type.

The library is built at first use with ``g++`` from
``cpp/reloc_forest/reloc_forest.cpp`` into ``build/ptzjax_torch/`` at the
root of the checkout (the reference's Makefile flags), keyed by a hash of
the source and the flags, so an edited source rebuilds. Nothing is written
under ``cpp/`` and no prebuilt library is loaded; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ptzjax_torch import _device
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import Intrinsics
from ptzjax_torch.reloc import RelocResult, solve_from_correspondences

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "cpp" / "reloc_forest" / "reloc_forest.cpp"
BUILD_DIR = _ROOT / "build" / "ptzjax_torch"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libreloc_forest_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the forest library unless one for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed with code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded forest library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rf_create.restype = ctypes.c_void_p
    lib.rf_create.argtypes = [ctypes.c_int] * 6 + [ctypes.c_uint32]
    lib.rf_destroy.argtypes = [ctypes.c_void_p]
    lib.rf_add_keyframe.restype = ctypes.c_int
    lib.rf_add_keyframe.argtypes = [ctypes.c_void_p, fp, fp, ctypes.c_int, ctypes.c_int]
    lib.rf_num_samples.restype = ctypes.c_int
    lib.rf_num_samples.argtypes = [ctypes.c_void_p]
    lib.rf_relocalize.restype = ctypes.c_int
    lib.rf_relocalize.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, fp, fp]
    lib.rf_save.restype = ctypes.c_int
    lib.rf_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rf_load.restype = ctypes.c_void_p
    lib.rf_load.argtypes = [ctypes.c_char_p]
    lib.rf_set_async.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rf_training.restype = ctypes.c_int
    lib.rf_training.argtypes = [ctypes.c_void_p]
    lib.rf_wait.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _host_f32(a) -> np.ndarray:
    """A contiguous fp32 host copy (tensors on any device, or arrays)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), np.float32)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ForestPrediction(NamedTuple):
    rays: np.ndarray   # (Q, 2) predicted (theta, phi)
    conf: np.ndarray   # (Q,) confidence in [0, 1]


class RelocForest:
    """Online-trained descriptor -> ray regressor (native BTDTR)."""

    def __init__(
        self,
        num_trees: int = 8,
        max_depth: int = 16,
        min_leaf: int = 4,
        candidate_dims: int = 16,
        candidate_thresh: int = 8,
        backtrack_leaves: int = 8,
        seed: int = 17,
        async_train: bool = False,
        _handle: int | None = None,
    ):
        """``async_train=True`` moves tree rebuilds to a native background
        thread: ``add_keyframe`` returns in about the sample copy's time and
        queries keep serving the previous trees while a build is in flight.
        Use ``wait()`` for deterministic hand-offs."""
        self._lib = load()
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.rf_create(
                num_trees, max_depth, min_leaf, candidate_dims,
                candidate_thresh, backtrack_leaves, seed,
            )
        if async_train:
            self._lib.rf_set_async(self._h, 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rf_destroy(h)
            self._h = None

    @property
    def num_samples(self) -> int:
        return self._lib.rf_num_samples(self._h)

    @property
    def training(self) -> bool:
        """True while an async background rebuild is in flight."""
        return bool(self._lib.rf_training(self._h))

    def wait(self) -> None:
        """Block until any in-flight background rebuild has swapped in."""
        self._lib.rf_wait(self._h)

    def add_keyframe(self, desc, rays, valid=None) -> int:
        """Train on one keyframe's (descriptor, ray) pairs. Rows with
        valid=False are dropped."""
        desc = _host_f32(desc)
        rays = _host_f32(rays)
        if valid is not None:
            keep = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool)
            desc, rays = desc[keep], rays[keep]
        if len(desc) == 0:
            return 0
        rc = self._lib.rf_add_keyframe(
            self._h, _fptr(desc), _fptr(rays), len(desc), desc.shape[1]
        )
        if rc != 0:
            raise ValueError("descriptor dimension mismatch")
        return len(desc)

    def predict(self, desc) -> ForestPrediction:
        """Regress a ray per descriptor."""
        desc = _host_f32(desc)
        q = len(desc)
        out_rays = np.zeros((q, 2), np.float32)
        out_conf = np.zeros((q,), np.float32)
        rc = self._lib.rf_relocalize(
            self._h, _fptr(desc), q, desc.shape[1], _fptr(out_rays),
            _fptr(out_conf),
        )
        if rc != q:
            raise RuntimeError("forest not trained (no keyframes added)")
        return ForestPrediction(out_rays, out_conf)

    def save(self, path: str) -> None:
        if self._lib.rf_save(self._h, path.encode()) != 0:
            raise IOError(f"cannot write {path}")

    @staticmethod
    def load(path: str) -> "RelocForest":
        h = load().rf_load(path.encode())
        if not h:
            raise IOError(f"cannot read forest from {path}")
        return RelocForest(_handle=h)


def relocalize_rf(
    forest: RelocForest,
    desc,
    xy,
    valid,
    intr: Intrinsics,
    cfg: SLAMConfig,
    min_conf: float = 0.55,
    device=None,
    f_range: tuple[float, float] = (800.0, 6000.0),
    num_f: int = 32,
    tol_px: float = 8.0,
) -> RelocResult:
    """Forest-backed relocalization: regress rays natively, solve the pose
    on ``device`` (by default that of ``xy`` if it is a tensor, else the
    card) through the shared vote + refine pipeline. Drop-in alternative to
    ``reloc.relocalize``.

    The descriptors and the validity go to the host for the forest: this
    runs once per lost frame, never on a tracked one. An untrained forest
    (possible with ``async_train`` while the first build is in flight)
    reports failure instead of raising: the caller stays lost and retries
    next frame."""
    dev = _device.resolve(device, xy)
    q = len(desc)
    try:
        pred = forest.predict(desc)
    except RuntimeError:
        return RelocResult(
            pose=torch.zeros(3, dtype=torch.float32, device=dev),
            inliers=torch.zeros((), dtype=torch.int64, device=dev),
            success=torch.zeros((), dtype=torch.bool, device=dev),
            matched_ray_ids=torch.full((q,), -1, dtype=torch.int32, device=dev),
            matched_ok=torch.zeros(q, dtype=torch.bool, device=dev),
        )
    host_valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else np.asarray(valid)
    w = torch.from_numpy(host_valid.astype(bool) & (pred.conf >= min_conf)).to(dev)
    pose, inl, n, success = solve_from_correspondences(
        torch.from_numpy(pred.rays).to(dev), torch.as_tensor(xy, device=dev), w, intr, cfg,
        f_range=f_range, num_f=num_f, tol_px=tol_px,
    )
    return RelocResult(
        pose=pose,
        inliers=n,
        success=success,
        matched_ray_ids=torch.full((q,), -1, dtype=torch.int32, device=dev),
        matched_ok=inl,
    )
