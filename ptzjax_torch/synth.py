"""Synthetic PTZ sequences with exact ground truth, host numpy. A jax-free
copy of ``ptzjax/synth.py`` with its seeds and RNG call order, so the tests
hold every generator bitwise equal to the reference.

- Keypoint oracle: a ground-truth (pan, tilt, focal) trajectory over a fixed
  ray field (``make_sequence``), or over rays of a 3D basketball-court scene
  seen through a base-rotation camera (``make_court_sequence``), rendered to
  noisy keypoint observations (``render_frame``).
- Video: a panorama in ray-angle space resampled through the trajectory
  (``render_image``), optionally with textured blobs that move on their own
  (``make_moving_blobs``, the player analogues) and their detection boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ptzjax_torch.geometry import Intrinsics


class SyntheticSequence(NamedTuple):
    """Ground truth for a synthetic broadcast sequence.

    Attributes:
      cameras: (T, 3) fp32 GT (pan, tilt, focal) per frame (radians, pixels).
      rays: (M, 2) fp32 GT landmark rays (theta, phi).
      descriptors: (M, D) fp32 unit-norm per-ray descriptors (stable identity
        for matching/relocalization tests).
      intr: shared intrinsics.
      width, height: image size in pixels.
    """

    cameras: np.ndarray
    rays: np.ndarray
    descriptors: np.ndarray
    intr: Intrinsics
    width: float
    height: float


def make_trajectory(
    num_frames: int,
    pan0: float = 0.0,
    pan_amp: float = 0.35,
    tilt0: float = -0.08,
    tilt_amp: float = 0.04,
    f0: float = 2500.0,
    f_amp: float = 600.0,
    period: float = 240.0,
    seed: int = 0,
) -> np.ndarray:
    """Smooth pan sweep + slow zoom, like a broadcast camera following play."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames, dtype=np.float64)
    # a couple of incommensurate sinusoids => smooth, non-repeating motion
    pan = pan0 + pan_amp * (
        np.sin(2 * np.pi * t / period) + 0.3 * np.sin(2 * np.pi * t / (period * 0.37) + 1.0)
    )
    tilt = tilt0 + tilt_amp * np.sin(2 * np.pi * t / (period * 1.7) + 0.5)
    f = f0 + f_amp * np.sin(2 * np.pi * t / (period * 2.3) + rng.uniform(0, 2 * np.pi))
    return np.stack([pan, tilt, f], axis=-1).astype(np.float32)


def make_ray_field(
    num_rays: int,
    pan_range: tuple[float, float] = (-0.8, 0.8),
    tilt_range: tuple[float, float] = (-0.25, 0.1),
    descriptor_dim: int = 128,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Static scene rays (stands/court texture) + stable unit descriptors."""
    rng = np.random.default_rng(seed + 1)
    rays = np.stack(
        [
            rng.uniform(*pan_range, num_rays),
            rng.uniform(*tilt_range, num_rays),
        ],
        axis=-1,
    ).astype(np.float32)
    desc = rng.normal(size=(num_rays, descriptor_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return rays, desc


def make_sequence(
    num_frames: int = 300,
    num_rays: int = 2000,
    width: float = 1280.0,
    height: float = 720.0,
    cx: float | None = None,
    cy: float | None = None,
    seed: int = 0,
    **traj_kw,
) -> SyntheticSequence:
    cx = width / 2 if cx is None else cx
    cy = height / 2 if cy is None else cy
    cameras = make_trajectory(num_frames, seed=seed, **traj_kw)
    rays, desc = make_ray_field(num_rays, seed=seed)
    intr = Intrinsics.create(cx, cy)
    return SyntheticSequence(cameras, rays, desc, intr, width, height)


# --- court-model synthesis ----------------------------------------------------


def look_at_base_rotation(center, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World -> camera-base rotation Rb for a camera at ``center`` whose base
    (pan=0, tilt=0) optical axis points at ``target``.

    Camera-base convention (matches geometry.rays_from_points): x right,
    y down, z forward — so theta = atan2(dx, dz) is pan-like and
    phi = atan2(-dy, hypot(dx, dz)) is tilt-like (positive = up).
    """
    fwd = np.asarray(target, np.float64) - np.asarray(center, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=0).astype(np.float32)


def make_court_points(
    length: float = 28.65,
    width: float = 15.24,
    court_step: float = 1.6,
    stand_rows: int = 8,
    stand_cols: int = 36,
    seed: int = 0,
) -> np.ndarray:
    """3D world points of a basketball-court scene (court-marking grid on
    the floor plane + a rising bank of stands behind the far sideline).

    World frame: x along the court length, y across it, z up; the court
    floor is z = 0 with corners (0, 0) and (length, width). Feature
    positions are tied to real 3D geometry instead of a free ray field, so
    this exercises the rays_from_points path.
    """
    rng = np.random.default_rng(seed + 17)
    xs = np.arange(0.0, length + 1e-6, court_step)
    ys = np.arange(0.0, width + 1e-6, court_step)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    court = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    # jitter breaks the perfect grid (a real detector never sees one)
    court[:, :2] += rng.uniform(-0.2, 0.2, (len(court), 2))

    sx = np.linspace(-2.0, length + 2.0, stand_cols)
    rows = np.arange(stand_rows)
    sgx, sgr = np.meshgrid(sx, rows, indexing="ij")
    stands = np.stack(
        [
            sgx,
            width + 2.0 + 0.9 * sgr,      # receding behind the far sideline
            1.0 + 0.8 * sgr,              # rising tiers
        ],
        -1,
    ).reshape(-1, 3)
    stands += rng.uniform(-0.25, 0.25, stands.shape)
    return np.concatenate([court, stands], 0).astype(np.float32)


def make_court_sequence(
    num_frames: int = 300,
    width: float = 1280.0,
    height: float = 720.0,
    camera_center=(14.3, -18.0, 7.0),
    look_target=(14.3, 9.0, 0.0),
    descriptor_dim: int = 128,
    seed: int = 0,
    **traj_kw,
) -> tuple[SyntheticSequence, np.ndarray]:
    """Court-model synthetic sequence: landmarks are 3D court/stand points
    converted to rays through the base-rotation camera model.

    Returns (sequence, points): ``sequence`` plugs into every harness
    (features.synth_features, PTZSlam, BA); ``points`` are the (M, 3) world
    points for reprojection-against-model evaluation.
    """
    rng = np.random.default_rng(seed)
    center = np.asarray(camera_center, np.float64)
    rb = look_at_base_rotation(center, look_target).astype(np.float64)
    points = make_court_points(seed=seed)

    d = (points.astype(np.float64) - center) @ rb.T
    theta = np.arctan2(d[:, 0], d[:, 2])
    phi = np.arctan2(-d[:, 1], np.hypot(d[:, 0], d[:, 2]))
    rays = np.stack([theta, phi], -1).astype(np.float32)

    desc = rng.normal(size=(len(rays), descriptor_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)

    # trajectory centered on the scene's ray spread
    traj_kw.setdefault("pan0", float(np.median(theta)))
    traj_kw.setdefault("tilt0", float(np.median(phi)))
    traj_kw.setdefault("pan_amp", float(0.45 * (theta.max() - theta.min()) / 2))
    traj_kw.setdefault("tilt_amp", 0.02)
    cameras = make_trajectory(num_frames, seed=seed, **traj_kw)

    intr = Intrinsics.create(
        width / 2.0, height / 2.0,
        center=center.astype(np.float32),
        base_rotation=rb.astype(np.float32),
    )
    seq = SyntheticSequence(cameras, rays, desc, intr, width, height)
    return seq, points


def _project_np(camera, rays, cx, cy):
    u = rays[:, 0] - camera[0]
    v = rays[:, 1] - camera[1]
    x = camera[2] * np.tan(u) + cx
    y = -camera[2] * np.tan(v) / np.cos(u) + cy
    return np.stack([x, y], axis=-1)


def render_frame(
    seq: SyntheticSequence,
    frame: int,
    noise_px: float = 0.5,
    outlier_frac: float = 0.0,
    dropout_frac: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one frame's observations.

    Returns:
      (pixels, visible, ray_ids): pixels (V, 2) noisy keypoint positions for
      the V visible rays, visible (M,) bool over the full ray field, ray_ids
      (V,) indices into seq.rays. Outliers are visible points teleported
      uniformly in the image; dropouts remove visible points at random.
    """
    rng = np.random.default_rng((seed + 7919) * 100003 + frame)
    cam = seq.cameras[frame].astype(np.float64)
    cx = float(seq.intr.cx)
    cy = float(seq.intr.cy)
    pix = _project_np(cam, seq.rays.astype(np.float64), cx, cy)
    u = np.abs(seq.rays[:, 0] - cam[0])
    v = np.abs(seq.rays[:, 1] - cam[1])
    visible = (
        (pix[:, 0] >= 0)
        & (pix[:, 0] < seq.width)
        & (pix[:, 1] >= 0)
        & (pix[:, 1] < seq.height)
        & (u < 1.2)
        & (v < 1.2)
    )
    if dropout_frac > 0:
        visible &= rng.random(len(visible)) >= dropout_frac
    ids = np.nonzero(visible)[0]
    obs = pix[ids] + rng.normal(scale=noise_px, size=(len(ids), 2))
    if outlier_frac > 0:
        bad = rng.random(len(ids)) < outlier_frac
        obs[bad, 0] = rng.uniform(0, seq.width, bad.sum())
        obs[bad, 1] = rng.uniform(0, seq.height, bad.sum())
    return obs.astype(np.float32), visible, ids.astype(np.int32)


class Panorama(NamedTuple):
    """Static scene texture in ray-angle space (theta, phi).

    Every frame of a PTZ camera is a resampling of one fixed panorama
    through the current (pan, tilt, focal), so rendering from it gives
    photometrically consistent video with exact ground truth.

    Attributes:
      tex: (PH, PW) fp32 texture.
      theta0, phi0: angle of texel (0, 0).
      dtheta, dphi: radians per texel.
    """

    tex: np.ndarray
    theta0: float
    phi0: float
    dtheta: float
    dphi: float


def make_panorama(
    theta_range: tuple[float, float] = (-1.0, 1.0),
    phi_range: tuple[float, float] = (-0.4, 0.25),
    texels_per_rad: float = 2500.0,
    octaves: int = 4,
    seed: int = 0,
) -> Panorama:
    """Multi-octave smoothed-noise texture: corners at many scales, no
    repeating structure (every Harris keypoint is locally unique)."""
    rng = np.random.default_rng(seed + 101)
    pw = int((theta_range[1] - theta_range[0]) * texels_per_rad)
    ph = int((phi_range[1] - phi_range[0]) * texels_per_rad)
    tex = np.zeros((ph, pw), np.float32)
    for o in range(octaves):
        step = 1 << (o + 3)  # 8, 16, 32, 64 texel features
        base = rng.normal(size=(ph // step + 2, pw // step + 2)).astype(np.float32)
        yy = np.arange(ph) / step
        xx = np.arange(pw) / step
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        interp = (
            base[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + base[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + base[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + base[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        tex += interp / (o + 1)
    tex = (tex - tex.mean()) / (tex.std() + 1e-9)
    return Panorama(
        tex=tex,
        theta0=theta_range[0],
        phi0=phi_range[0],
        dtheta=(theta_range[1] - theta_range[0]) / pw,
        dphi=(phi_range[1] - phi_range[0]) / ph,
    )


def _pixel_angles(camera, intr: Intrinsics, width: int, height: int):
    """Per-pixel ray angles (theta, phi) for one frame — the exact inverse
    of the projection model."""
    cam = np.asarray(camera, np.float64)
    cx = float(intr.cx)
    cy = float(intr.cy)
    x = np.arange(width, dtype=np.float64)[None, :] - cx
    y = np.arange(height, dtype=np.float64)[:, None] - cy
    u = np.arctan2(x, cam[2])
    theta = cam[0] + u
    phi = cam[1] + np.arctan2(-y * np.cos(u), cam[2])
    return theta, phi


def _sample_bilinear(tex: np.ndarray, tx, ty) -> np.ndarray:
    h, w = tex.shape
    tx = np.clip(tx, 0, w - 2)
    ty = np.clip(ty, 0, h - 2)
    x0 = tx.astype(int)
    y0 = ty.astype(int)
    fx = (tx - x0).astype(np.float32)
    fy = (ty - y0).astype(np.float32)
    return (
        tex[y0, x0] * (1 - fy) * (1 - fx)
        + tex[y0, x0 + 1] * (1 - fy) * fx
        + tex[y0 + 1, x0] * fy * (1 - fx)
        + tex[y0 + 1, x0 + 1] * fy * fx
    )


def render_image(
    pano: Panorama,
    camera: np.ndarray,
    intr: Intrinsics,
    width: int,
    height: int,
    movers: "MovingBlobs | None" = None,
    frame: int = 0,
) -> np.ndarray:
    """Render one (height, width) fp32 frame: back-project every pixel to its
    ray and bilinearly sample the panorama. With ``movers``, composite the
    moving textured blobs of ``frame`` on top: their texture rides the blob,
    not the panorama, so their corners move against the camera's motion."""
    theta, phi = _pixel_angles(camera, intr, width, height)
    tx = (theta - pano.theta0) / pano.dtheta
    ty = (phi - pano.phi0) / pano.dphi
    img = _sample_bilinear(pano.tex, tx, ty).astype(np.float32)
    if movers is not None:
        img = _composite_movers(img, movers, frame, theta, phi)
    return img


# --- moving objects (player analogues) ----------------------------------------


class MovingBlobs(NamedTuple):
    """Textured blobs moving through angle space with their own motion.

    The stand-in for broadcast players: spatially coherent, temporally
    persistent texture whose image motion disagrees with the camera's, so
    features detected on a blob form correlated wrong-motion observations
    (what player-box masks exclude).

    Attributes:
      tex: (B, S, S) fp32 per-blob texture (blob-local frame).
      theta, phi: (T, B) blob center angles per frame.
      ang_w, ang_h: (B,) angular full width/height of each blob.
    """

    tex: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    ang_w: np.ndarray
    ang_h: np.ndarray


def make_moving_blobs(
    num_frames: int,
    num_blobs: int = 8,
    theta_range: tuple[float, float] = (-0.45, 0.45),
    phi_range: tuple[float, float] = (-0.18, 0.02),
    ang_w: float = 0.075,
    aspect: float = 2.2,
    speed: float = 0.006,
    tex_size: int = 96,
    contrast: float = 1.6,
    seed: int = 0,
) -> MovingBlobs:
    """Player-like motion: each blob follows a smooth incommensurate-
    sinusoid path inside (theta_range, phi_range) at ~``speed`` rad/frame
    (a player at 5 m/s seen from 20 m is ~0.01 rad/frame at 25 fps).
    Textures are multi-octave noise like the panorama (every blob carries
    real Harris corners) boosted by ``contrast`` so the detector cannot
    ignore them."""
    rng = np.random.default_rng(seed + 977)
    t = np.arange(num_frames, dtype=np.float64)
    thetas = np.zeros((num_frames, num_blobs))
    phis = np.zeros((num_frames, num_blobs))
    tc = 0.5 * (theta_range[0] + theta_range[1])
    ta = 0.5 * (theta_range[1] - theta_range[0])
    pc = 0.5 * (phi_range[0] + phi_range[1])
    pa = 0.5 * (phi_range[1] - phi_range[0])
    for b in range(num_blobs):
        # period chosen so peak angular speed ~= speed: a*2pi/T = speed
        a1 = rng.uniform(0.5, 1.0) * ta
        T1 = max(2 * np.pi * a1 / speed, 8.0)
        a2 = 0.3 * a1
        thetas[:, b] = (
            tc
            + a1 * np.sin(2 * np.pi * t / T1 + rng.uniform(0, 2 * np.pi))
            + a2 * np.sin(2 * np.pi * t / (T1 * 0.41) + rng.uniform(0, 2 * np.pi))
        )
        ap = rng.uniform(0.4, 1.0) * pa
        Tp = max(2 * np.pi * ap / (0.4 * speed), 8.0)
        phis[:, b] = pc + ap * np.sin(
            2 * np.pi * t / Tp + rng.uniform(0, 2 * np.pi)
        )
    tex = np.zeros((num_blobs, tex_size, tex_size), np.float32)
    for b in range(num_blobs):
        acc = np.zeros((tex_size, tex_size), np.float32)
        for o in range(3):
            step = 1 << (o + 3)
            base = rng.normal(
                size=(tex_size // step + 2, tex_size // step + 2)
            ).astype(np.float32)
            idx = np.arange(tex_size) / step
            i0 = idx.astype(int)
            f = (idx - i0).astype(np.float32)
            fy, fx = f[:, None], f[None, :]
            acc += (
                base[np.ix_(i0, i0)] * (1 - fy) * (1 - fx)
                + base[np.ix_(i0, i0 + 1)] * (1 - fy) * fx
                + base[np.ix_(i0 + 1, i0)] * fy * (1 - fx)
                + base[np.ix_(i0 + 1, i0 + 1)] * fy * fx
            ) / (o + 1)
        acc = (acc - acc.mean()) / (acc.std() + 1e-9)
        tex[b] = contrast * acc
    return MovingBlobs(
        tex=tex,
        theta=thetas.astype(np.float32),
        phi=phis.astype(np.float32),
        ang_w=np.full((num_blobs,), ang_w, np.float32),
        ang_h=np.full((num_blobs,), ang_w * aspect, np.float32),
    )


def _composite_movers(img, movers: MovingBlobs, frame, theta, phi):
    """Overlay each blob: pixels whose ray falls inside the blob's angular
    ellipse sample the BLOB texture (blob-local coordinates)."""
    out = img
    s = movers.tex.shape[1]
    for b in range(movers.tex.shape[0]):
        u = (theta - movers.theta[frame, b]) / movers.ang_w[b] + 0.5
        v = (movers.phi[frame, b] - phi) / movers.ang_h[b] + 0.5
        inside = (
            ((u - 0.5) ** 2 + (v - 0.5) ** 2) * 4.0 < 1.0
        )
        if not inside.any():
            continue
        val = _sample_bilinear(movers.tex[b], u * (s - 1), v * (s - 1))
        out = np.where(inside, val.astype(np.float32), out)
    return out


def mover_boxes(
    movers: MovingBlobs,
    frame: int,
    camera: np.ndarray,
    intr: Intrinsics,
    width: int,
    height: int,
    pad_px: float = 4.0,
) -> np.ndarray:
    """Pixel bounding boxes (B', 4) = (x1, y1, x2, y2) of the blobs visible
    in ``frame`` (the analogue of player detections); feed to
    ``io.boxes_to_mask`` for the detection mask."""
    cam = np.asarray(camera, np.float64)
    boxes = []
    for b in range(movers.tex.shape[0]):
        hw = 0.5 * movers.ang_w[b]
        hh = 0.5 * movers.ang_h[b]
        tc, pc = movers.theta[frame, b], movers.phi[frame, b]
        corners = np.asarray(
            [
                [tc - hw, pc - hh],
                [tc - hw, pc + hh],
                [tc + hw, pc - hh],
                [tc + hw, pc + hh],
            ],
            np.float64,
        )
        pix = _project_np(cam, corners, float(intr.cx), float(intr.cy))
        x1, y1 = pix.min(axis=0) - pad_px
        x2, y2 = pix.max(axis=0) + pad_px
        if x2 < 0 or y2 < 0 or x1 >= width or y1 >= height:
            continue
        boxes.append(
            [max(x1, 0.0), max(y1, 0.0), min(x2, width), min(y2, height)]
        )
    if not boxes:
        return np.zeros((0, 4), np.float32)
    return np.asarray(boxes, np.float32)


def mover_pixel_fraction(
    movers: MovingBlobs, frame: int, camera, intr, width: int, height: int
) -> float:
    """Fraction of the frame's pixels covered by blobs (test sizing)."""
    theta, phi = _pixel_angles(camera, intr, width, height)
    covered = np.zeros((height, width), bool)
    for b in range(movers.tex.shape[0]):
        u = (theta - movers.theta[frame, b]) / movers.ang_w[b] + 0.5
        v = (movers.phi[frame, b] - phi) / movers.ang_h[b] + 0.5
        covered |= ((u - 0.5) ** 2 + (v - 0.5) ** 2) * 4.0 < 1.0
    return float(covered.mean())


def render_sequence_padded(
    seq: SyntheticSequence,
    max_obs: int,
    noise_px: float = 0.5,
    outlier_frac: float = 0.0,
    dropout_frac: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render every frame into fixed-capacity padded tables.

    Returns:
      pixels: (T, max_obs, 2), ray_ids: (T, max_obs) int32 (-1 padding),
      valid: (T, max_obs) bool. If a frame sees more than max_obs rays a
      random subset is kept (deterministic per seed).
    """
    T = len(seq.cameras)
    pixels = np.zeros((T, max_obs, 2), np.float32)
    ray_ids = np.full((T, max_obs), -1, np.int32)
    valid = np.zeros((T, max_obs), bool)
    for k in range(T):
        obs, _, ids = render_frame(
            seq, k, noise_px=noise_px, outlier_frac=outlier_frac,
            dropout_frac=dropout_frac, seed=seed,
        )
        n = len(ids)
        if n > max_obs:
            sel = np.random.default_rng(seed * 31 + k).choice(n, max_obs, replace=False)
            sel.sort()
            obs, ids = obs[sel], ids[sel]
            n = max_obs
        pixels[k, :n] = obs
        ray_ids[k, :n] = ids
        valid[k, :n] = True
    return pixels, ray_ids, valid
