"""Shared inputs for the ptzjax_torch parity tests: configs carried across
packages and a small rendered sequence.

Each test builds its inputs with numpy from a seed and feeds the same
arrays to the JAX reference (on the CPU, plain jnp paths) and to the port.
"""

from __future__ import annotations

import dataclasses
import fcntl
from pathlib import Path

import numpy as np
import torch

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics
from ptzjax_torch.config import SLAMConfig as PortConfig
from ptzjax_torch.geometry import Intrinsics as PortIntrinsics

W, H = 640, 360


def small_cfg(**kw) -> SLAMConfig:
    """tests/test_frontend.py's small configuration (160 kp / 96 rays / 1024
    map rays / 16 keyframes)."""
    base = dict(
        image_width=W, image_height=H, max_keypoints=160, max_rays=96,
        max_map_rays=1024, max_keyframes=16, kf_desc_dim=128, sigma_obs=1.0,
        min_inliers=10,
    )
    base.update(kw)
    return SLAMConfig(**base)


def port_cfg(cfg: SLAMConfig) -> PortConfig:
    return PortConfig(**dataclasses.asdict(cfg))


def port_intr(intr: Intrinsics) -> PortIntrinsics:
    return PortIntrinsics(*intr)


def render(num_frames, f0=1100.0, pan_amp=0.12, f_amp=60.0, seed=0):
    """tests/test_frontend.py's 640x360 panorama sweep."""
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=2200.0, seed=seed
    )
    cams = synth.make_trajectory(
        num_frames, pan_amp=pan_amp, tilt0=-0.05, tilt_amp=0.02, f0=f0, f_amp=f_amp,
        period=num_frames * 1.6, seed=seed,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    imgs = np.stack([synth.render_image(pano, c, intr, W, H) for c in cams])
    return imgs, cams, intr


def t(x) -> torch.Tensor:
    """A CPU tensor holding a copy of a numpy / jax array."""
    return torch.from_numpy(np.array(x, copy=True))


def n(x) -> np.ndarray:
    """A numpy copy of a torch tensor or jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def texture(h=96, w=160, seed=0) -> np.ndarray:
    """Smooth random texture (tests/test_kernels.py's): corners everywhere."""
    from tests.oracle.harris_np import smooth5_np

    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h // 8 + 1, w // 8 + 1))
    img = np.kron(base, np.ones((8, 8)))[:h, :w]
    return smooth5_np(smooth5_np(img)).astype(np.float32)


def reference_forest_module():
    """``ptzjax.reloc_forest`` with its library built under an exclusive
    lock, so test workers never load a half-written file."""
    from ptzjax import reloc_forest
    from ptzjax_torch.reloc_forest import BUILD_DIR

    Path(BUILD_DIR).mkdir(parents=True, exist_ok=True)
    with open(Path(BUILD_DIR) / "reference_forest.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        reloc_forest._load_lib()
    return reloc_forest
