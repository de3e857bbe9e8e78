"""Experiment runner CLI: ``python -m ptzjax_torch.run``. Port of
``ptzjax/run.py``.

Run the online SLAM loop over a sequence, optionally bundle-adjust at the
end, and write the run's artifacts: the per-frame log ``frames.jsonl``, the
eval summary ``summary.json`` against ground truth, and ``trajectory.npz``.

Modes:
  --synthetic          keypoint-oracle sequence (no images; EKF/map/BA path)
  --synthetic-court    court-model oracle: landmarks from 3D basketball-court
                       geometry via the base-rotation camera
  --synthetic-images   panorama-rendered video through the vision kernels
  --annotation/--images  dataset mode (.mat/.npz annotations + frames)

Execution modes (any input mode):
  (default)            the online SLAM loop
  --tracker homography the frame-to-frame homography-EKF baseline
  --offline            sharded frontend, tracking, then sharded BA over the
                       map (``dist``); several cards through torchrun

It runs on the card (``--device`` defaults to ``cuda`` and raises where
there is none); ``--device cpu`` runs the kernels' plain versions on the
CPU.

Example:
  python -m ptzjax_torch.run --synthetic --frames 240 --out /tmp/run1
  python -m ptzjax_torch.run --annotation seq.mat --images frames/ --out /tmp/run2
  torchrun --nproc-per-node 4 -m ptzjax_torch.run --synthetic-images --offline --out /tmp/run3
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ptzjax_torch import _device
from ptzjax_torch import checkpoint as ckpt
from ptzjax_torch import eval as evallib
from ptzjax_torch import io as iolib
from ptzjax_torch import synth
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.features import synth_features
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics
from ptzjax_torch.slam import PTZSlam, SlamState, infos_to_dicts


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ptzjax_torch SLAM experiment runner")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-court", action="store_true")
    p.add_argument("--synthetic-images", action="store_true")
    p.add_argument("--annotation", type=str, default=None)
    p.add_argument("--images", type=str, default=None)
    p.add_argument("--frames", type=int, default=240)
    p.add_argument("--config", type=str, default=None, help="SLAMConfig JSON")
    p.add_argument("--out", type=str, required=True, help="output directory")
    p.add_argument("--ba", action="store_true", help="final bundle adjustment")
    p.add_argument(
        "--ba-huber", type=float, default=None,
        help="Huber kernel width (px) for robust IRLS bundle adjustment "
             "(ba.run_robust); overrides cfg.ba_huber_px. 0 = pure "
             "quadratic. Use ~3 when matches may contain outliers",
    )
    p.add_argument(
        "--klt", action="store_true",
        help="image modes: carry keypoints between frames with pyramidal LK "
             "optical flow (detect only to refill) instead of re-detecting "
             "every frame",
    )
    p.add_argument(
        "--reloc", type=str, default="map",
        choices=["map", "keyframe", "forest"],
        help="relocalization backend: 'map' matches the global ray store, "
             "'keyframe' does the nearest-keyframe lookup, 'forest' uses the "
             "native C++ BTDTR regressor trained online from keyframes",
    )
    p.add_argument(
        "--frontend", type=str, default="kernels", choices=["kernels", "cv2"],
        help="image modes: 'kernels' = the port's Harris/SIFT/LK frontend "
             "(its CUDA kernels on the card, their plain versions on the "
             "CPU); 'cv2' = OpenCV SIFT + calcOpticalFlowPyrLK ingestion",
    )
    p.add_argument(
        "--tracker", type=str, default="slam", choices=["slam", "homography"],
        help="'slam' = the full keyframe+map system; 'homography' = the "
             "frame-to-frame homography-EKF baseline (ptzjax_torch.baselines), "
             "the drift comparison; image modes stage its features first",
    )
    p.add_argument(
        "--plot", action="store_true",
        help="write trajectory/error curves (trajectory.png, matplotlib)",
    )
    p.add_argument(
        "--chunk", type=int, default=64,
        help="frames between host reads of the per-frame info: a run with "
             "checkpoints or the forest reads each chunk's records when it "
             "ends, any other run reads them all at the end",
    )
    p.add_argument(
        "--offline", action="store_true",
        help="offline execution mode: frame-parallel feature extraction "
             "over the mesh (dist.extract_features_sharded), the tracking "
             "loop, then ray-sharded bundle adjustment over the mesh (robust "
             "when --ba-huber > 0); summary.json adds ba_cost_before/after. "
             "Under torchrun every process joins the mesh",
    )
    p.add_argument(
        "--oracle-focals", action="store_true",
        help="--offline: zoom-normalize descriptors with per-frame "
             "ground-truth focals instead of the frame-0 focal. Leaks ground "
             "truth into the frontend: for frontend ablations only",
    )
    p.add_argument(
        "--mesh-devices", type=int, default=0,
        help="--offline: devices in the 1-D mesh, one process each (0 = "
             "every process of the world; 1 = this process alone, no "
             "collective)",
    )
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument(
        "--resume", type=str, default=None,
        help="resume from a state checkpoint (.npz written by "
             "--checkpoint-every, by this package or by ptzjax.run); "
             "continues at the frame after the checkpoint's frame_idx",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument(
        "--desc-f-ref", type=float, default=None,
        help="descriptor zoom-normalization reference focal: descriptors "
             "sample at f/f_ref spacing so their angular footprint is "
             "zoom-invariant. Default: AUTO (the init pose's focal); "
             "0 disables; > 0 pins an explicit value",
    )
    p.add_argument(
        "--f0", type=float, default=2500.0,
        help="--synthetic-images: trajectory mean focal (px)",
    )
    p.add_argument(
        "--f-amp", type=float, default=600.0,
        help="--synthetic-images: trajectory focal sweep amplitude (px); "
             "f0=2000 --f-amp 670 is a ~2x zoom sweep",
    )
    p.add_argument(
        "--pan-amp", type=float, default=0.35,
        help="--synthetic-images: trajectory pan amplitude (rad)",
    )
    p.add_argument(
        "--period", type=float, default=240.0,
        help="--synthetic-images: trajectory base period (frames); "
             "period ~ frames/2 makes the focal sine sweep its full range "
             "within the run",
    )
    p.add_argument(
        "--movers", type=int, default=0,
        help="--synthetic-images: composite N textured moving blobs (player "
             "analogues with their own motion) into the rendered frames; "
             "detection masks from their bounding boxes are applied by "
             "default",
    )
    p.add_argument(
        "--movers-unmasked", action="store_true",
        help="--movers: do NOT mask the blobs out of detection (the "
             "robustness stress: tracking must carry or fail loudly as "
             "'lost')",
    )
    p.add_argument(
        "--device", type=str, default=None,
        help="where to run: the card by default (raises without one); "
             "'cpu' runs the kernels' plain versions on the CPU",
    )
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


class Inputs(NamedTuple):
    """What a mode hands the loop. Exactly one of ``imgs`` (the fused
    from-pixels path) and ``feats`` (feature tables) is set."""

    cfg: SLAMConfig
    intr: Intrinsics
    gt: np.ndarray                 # (T, 3) ground-truth (pan, tilt, focal)
    imgs: Any = None               # (T, H, W) fp32 frames, numpy or a tensor
    masks: Any = None              # (T, H, W) bool, True where detection is allowed
    feats: list | None = None      # per frame (xy, desc, valid)
    meta: dict | None = None       # extra summary keys (the movers' metadata)


class RunResult(NamedTuple):
    summary: dict[str, Any]
    records: list[dict[str, Any]]
    ba: dict[str, float] | None    # the BA costs with --ba or --offline
    state: Any                     # SlamState (VOState for --tracker homography)
    forest_frames: list[int]       # frames the forest relocalized on the host


def make_config(args: argparse.Namespace) -> SLAMConfig:
    cfg = SLAMConfig()
    if args.config:
        with open(args.config) as f:
            cfg = SLAMConfig.from_json(f.read())
    cfg = cfg.replace(image_width=args.width, image_height=args.height, reloc_mode=args.reloc)
    if args.ba_huber is not None:
        cfg = cfg.replace(ba_huber_px=float(args.ba_huber))
    return cfg


def assemble(args: argparse.Namespace) -> Inputs:
    """The mode's frames or feature tables, ground truth and intrinsics."""
    cfg = make_config(args)
    if args.synthetic_court:
        seq, _points = synth.make_court_sequence(
            num_frames=args.frames, width=args.width, height=args.height,
            f0=1800.0, f_amp=150.0, period=args.frames * 1.5, seed=args.seed,
        )
        feats = [
            tuple(synth_features(seq, k, cfg.max_keypoints, seed=args.seed)[0])
            for k in range(args.frames)
        ]
        return Inputs(cfg, seq.intr, seq.cameras, feats=feats)
    if args.synthetic:
        seq = synth.make_sequence(
            num_frames=args.frames, num_rays=2500,
            width=args.width, height=args.height, seed=args.seed,
        )
        rng = np.random.default_rng(args.seed)
        desc = rng.normal(size=(2500, cfg.kf_desc_dim)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        seq = seq._replace(descriptors=desc)
        feats = [
            tuple(synth_features(seq, k, cfg.max_keypoints, seed=args.seed)[0])
            for k in range(args.frames)
        ]
        intr = Intrinsics.create(float(seq.intr.cx), float(seq.intr.cy))
        return Inputs(cfg, intr, seq.cameras, feats=feats)
    if args.synthetic_images:
        intr = Intrinsics.create(args.width / 2.0, args.height / 2.0)
        pano = synth.make_panorama(seed=args.seed)
        gt = synth.make_trajectory(
            args.frames, pan_amp=args.pan_amp, f0=args.f0, f_amp=args.f_amp,
            period=args.period, seed=args.seed,
        )
        movers = None
        if args.movers > 0:
            movers = synth.make_moving_blobs(args.frames, num_blobs=args.movers, seed=args.seed)
        imgs = np.stack([
            synth.render_image(pano, c, intr, args.width, args.height, movers=movers, frame=k)
            for k, c in enumerate(gt)
        ])
        masks = None
        meta = None
        if movers is not None and not args.movers_unmasked:
            masks = np.stack([
                iolib.boxes_to_mask(
                    synth.mover_boxes(movers, k, gt[k], intr, args.width, args.height),
                    args.height, args.width,
                )
                for k in range(args.frames)
            ])
        if movers is not None:
            mid = args.frames // 2
            meta = {
                "movers": args.movers,
                "movers_masked": not args.movers_unmasked,
                "mover_pixel_frac_mid": round(
                    synth.mover_pixel_fraction(movers, mid, gt[mid], intr, args.width, args.height), 4
                ),
            }
        return image_inputs(args, cfg, intr, gt, imgs, masks, meta)
    if not args.annotation or not args.images:
        raise SystemExit("dataset mode needs --annotation and --images")
    seqm = iolib.SequenceManager(args.annotation, args.images)
    gt = seqm.ann.cameras[: args.frames]
    n = min(args.frames, seqm.length)
    imgs = np.stack([seqm.get_image(k) for k in range(n)])
    # an annotation without player boxes (.npz) gives no mask at all
    masks = None
    if seqm.ann.bboxes is not None:
        masks = np.stack([seqm.get_mask(k, imgs.shape[1], imgs.shape[2]) for k in range(n)])
    return image_inputs(args, cfg, seqm.ann.intr, gt, imgs, masks)


def image_inputs(args, cfg: SLAMConfig, intr: Intrinsics, gt, imgs, masks=None, meta=None) -> Inputs:
    """Frames (T, H, W) -> the loop's inputs: the descriptor zoom
    normalization resolved (from ``gt[0]`` or --desc-f-ref), and for
    ``--frontend cv2`` or ``--tracker homography`` the feature tables
    staged frame by frame."""
    cfg = _resolve_f_ref(cfg, args, gt)
    feats = _stage_image_features(args, cfg, imgs, masks)
    return Inputs(cfg, intr, gt, imgs=imgs if feats is None else None, masks=masks, feats=feats, meta=meta)


def _resolve_f_ref(cfg: SLAMConfig, args, gt) -> SLAMConfig:
    """Descriptor zoom normalization for the image modes: --desc-f-ref
    overrides; the AUTO sentinel (-1) anchors to the init pose's focal."""
    if args.desc_f_ref is not None:
        cfg = cfg.replace(descriptor_f_ref=float(args.desc_f_ref))
    if cfg.descriptor_f_ref < 0:
        cfg = cfg.replace(descriptor_f_ref=float(gt[0][2]))
    return cfg


def _stage_image_features(args, cfg, imgs, masks) -> list | None:
    """Feature tables extracted frame by frame before the loop: with OpenCV
    on the host for ``--frontend cv2``, with the port's frontend on the
    device for ``--tracker homography`` (no zoom normalization, as the
    reference stages them; ``--klt`` carries the table with LK). None for
    the port's frontend under the SLAM tracker, which runs inside the loop
    (the fused path)."""
    if args.frontend != "cv2" and args.tracker == "slam":
        return None
    if args.frontend == "cv2":
        from ptzjax_torch.frontend_cv2 import extract_features_cv2, track_features_cv2

        def extract(img, mask):
            return tuple(extract_features_cv2(img, cfg, mask=mask))

        def track(prev_img, img, prev, mask):
            return track_features_cv2(prev_img, img, *prev, cfg, mask=mask)[:3]
    else:
        from ptzjax_torch.frontend import track_features

        dev = _device.resolve(args.device)

        def extract(img, mask):
            return extract_features(
                torch.as_tensor(img, device=dev), cfg,
                mask=None if mask is None else torch.as_tensor(mask, device=dev),
            )

        def track(prev_img, img, prev, mask):
            return track_features(prev_img, img, prev[0], prev[2], cfg, mask=mask, device=dev)[:3]

    feats: list = []
    for k in range(len(imgs)):
        mask = None if masks is None else masks[k]
        if args.klt and k > 0:
            feats.append(track(imgs[k - 1], imgs[k], feats[-1], mask))
        else:
            feats.append(extract(imgs[k], mask))
    return feats


def run_sequence(args: argparse.Namespace, inp: Inputs) -> RunResult:
    """The loop after input assembly: init on frame 0 (or ``--resume``),
    chunks of ``--chunk`` frames (stopping on checkpoint frames), the
    forest's host loop on lost frames, ``--ba``, and the artifacts in
    ``args.out``. ``summary["fps"]`` times the loop only: the kernel build
    and load (and the forest library's) happen before the clock."""
    os.makedirs(args.out, exist_ok=True)
    device = _device.resolve(args.device)
    cfg, intr, gt = inp.cfg, inp.intr, inp.gt
    imgs_all, masks_all, feats = inp.imgs, inp.masks, inp.feats
    fused = feats is None
    slam = PTZSlam(cfg, intr, device=device)
    print(f"device: {device}")

    def on_device(a, k, end=None):
        if a is None:
            return None
        return torch.as_tensor(a[k] if end is None else a[k:end], device=device)

    if device.type == "cuda":
        from ptzjax_torch.kernels import _build

        _build.load()
    if fused:
        feats0 = extract_features(
            on_device(imgs_all, 0), cfg, mask=on_device(masks_all, 0), focal=float(gt[0][2])
        )
        state = slam.init(*feats0, gt[0])
        total = len(imgs_all)
        klt_carry = [imgs_all[0], feats0[0], feats0[2]]   # img, xy, valid
    else:
        state = slam.init(*feats[0], gt[0])
        total = len(feats)
        xy_all = np.stack([np.asarray(f[0]) for f in feats])
        desc_all = np.stack([np.asarray(f[1]) for f in feats])
        valid_all = np.stack([np.asarray(f[2]) for f in feats])

    start_k = 1
    if args.resume:
        state = ckpt.load_pytree(args.resume, like=state)
        start_k = int(state.frame_idx) + 1
        print(f"resumed from {args.resume} at frame {start_k}")
        if fused and args.klt and start_k > 1:
            f_prev = extract_features(
                on_device(imgs_all, start_k - 1), cfg, mask=on_device(masks_all, start_k - 1),
                focal=state.ekf.cam[2],
            )
            klt_carry = [imgs_all[start_k - 1], f_prev[0], f_prev[2]]
    if start_k >= total:
        raise SystemExit(f"nothing to do: start frame {start_k} >= sequence length {total}")

    forest = None
    trained_kf = 0

    def train_forest_on_new_keyframes(state: SlamState) -> None:
        """Feed keyframes inserted since the last call to the native forest
        (online training); their tables come to the host here, on insert
        chunks only."""
        nonlocal trained_kf
        n_kf = int(state.kf.count)
        if n_kf <= trained_kf:
            return
        kf = state.kf
        desc, ray_ids, feat_valid = (
            v[trained_kf:n_kf].cpu().numpy() for v in (kf.desc, kf.ray_ids, kf.feat_valid)
        )
        rays = state.rays.rays.cpu().numpy()
        for i in range(n_kf - trained_kf):
            keep = feat_valid[i] & (ray_ids[i] >= 0)
            forest.add_keyframe(desc[i], rays[np.clip(ray_ids[i], 0, None)], valid=keep)
        trained_kf = n_kf

    if args.reloc == "forest":
        from ptzjax_torch.reloc_forest import RelocForest, relocalize_rf

        # rebuilds run on a native background thread, so keyframe-time
        # training never stalls the loop; lost-frame queries serve the
        # previous trees until the new build swaps in
        forest = RelocForest(async_train=True)
        train_forest_on_new_keyframes(state)

    chunk = max(1, args.chunk)

    def run_chunk(state: SlamState, k: int, end: int):
        """Frames [k, end) in one call (the last chunk runs short)."""
        if not fused:
            return slam.run_segment(state, xy_all[k:end], desc_all[k:end], valid_all[k:end])
        imgs_c = on_device(imgs_all, k, end)
        masks_c = on_device(masks_all, k, end)
        if args.klt:
            state, infos, xy_t, valid_t = slam.run_segment_pixels_klt(
                state, imgs_c, *klt_carry, masks=masks_c
            )
            klt_carry[:] = [imgs_c[-1], xy_t, valid_t]
            return state, infos
        return slam.run_segment_pixels(state, imgs_c, masks_c)

    def host_features(state: SlamState, k: int):
        """One frame's features for the forest."""
        if not fused:
            return feats[k]
        return extract_features(
            on_device(imgs_all, k), cfg, mask=on_device(masks_all, k), focal=state.ekf.pose[2]
        )

    records: list[dict[str, Any]] = []
    forest_frames: list[int] = []
    interactive = forest is not None or args.checkpoint_every
    pending = []   # (k, end, infos) of the non-interactive path, read at the end
    lost_host = False
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    k = start_k
    while k < total:
        if forest is not None and lost_host:
            # the host resolves frames the in-loop relocalization did not
            # recover through the native regressor, one frame at a time
            # until tracking resumes
            xy, desc, valid = host_features(state, k)
            res = relocalize_rf(forest, desc, xy, valid, intr, cfg, device=device)
            state = slam.apply_reloc_result(state, xy, desc, valid, res)
            lost_host = not bool(res.success)
            records.append({
                "frame": k, "event": "reloc", "lost": lost_host,
                "reloc_success": not lost_host,
                "reloc_inliers": int(res.inliers),
                "pose": state.ekf.pose.cpu().numpy(),
                "num_matches": int(res.inliers), "num_used": int(res.inliers),
                "innovation_rms": 0.0, "keyframe": False,
                "active_slots": int(state.ekf.active.sum()),
                "max_kf_overlap": 1.0,
            })
            forest_frames.append(k)
            k += 1
            continue
        end = min(k + chunk, total)
        if args.checkpoint_every:
            # stop chunks exactly on checkpoint frames
            next_ckpt = ((k - 1) // args.checkpoint_every + 1) * args.checkpoint_every
            end = min(end, next_ckpt + 1)
        pre_state = state
        pre_carry = list(klt_carry) if fused and args.klt else None
        state, infos = run_chunk(pre_state, k, end)
        if not interactive:
            pending.append((k, end, infos))
            k = end
            continue
        recs = infos_to_dicts(infos, frame0=k)
        if forest is not None:
            first_lost = next((j for j, r in enumerate(recs) if r["lost"]), None)
            if first_lost is not None and k + first_lost + 1 < end:
                # rewind to the first lost frame so the forest engages
                # immediately instead of after up to chunk-1 wasted frames;
                # the chunk reruns from pre_state, which no step modifies
                end = k + first_lost + 1
                if pre_carry is not None:
                    klt_carry[:] = pre_carry
                state, infos = run_chunk(pre_state, k, end)
                recs = infos_to_dicts(infos, frame0=k)
        records.extend(recs)
        if forest is not None:
            if any(r["keyframe"] for r in recs):
                train_forest_on_new_keyframes(state)
            lost_host = recs[-1]["lost"]
        if args.checkpoint_every and (end - 1) % args.checkpoint_every == 0:
            ckpt.save_pytree(os.path.join(args.out, f"state_{end - 1:06d}.npz"), state)
        k = end
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for k0, _, infos in pending:
        records.extend(infos_to_dicts(infos, frame0=k0))

    ba_info = None
    if args.ba:
        state, ba_info = slam.bundle_adjust(state)
        print("BA:", json.dumps(ba_info))

    pose = np.stack([r["pose"] for r in records])
    gt_r = gt[np.array([r["frame"] for r in records])]
    summary = {
        "fps": (total - start_k) / wall,
        "frames_lost": sum(r["lost"] for r in records),
        "keyframes": sum(r["keyframe"] for r in records),
        "frontend": "fused" if fused else ("cv2" if args.frontend == "cv2" else "staged"),
        **(inp.meta or {}),
    }
    _write_artifacts(args, records, pose, gt_r, intr, device, summary, os.path.basename(args.out.rstrip("/")))
    return RunResult(summary, records, ba_info, state, forest_frames)


def _stacked(feats, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame (xy, desc, valid) tables stacked on ``device``."""
    return tuple(torch.stack([torch.as_tensor(f[i], device=device) for f in feats]) for i in range(3))


def _write_artifacts(args, records, pose, gt_r, intr, device, summary, title) -> None:
    """frames.jsonl, trajectory.npz, summary.json (and --plot's figure);
    ``summary`` gains the trajectory errors and the reprojection RMSE."""
    iolib.write_trajectory_jsonl(os.path.join(args.out, "frames.jsonl"), records)
    np.savez(os.path.join(args.out, "trajectory.npz"), pose=pose, gt=gt_r)
    summary.update({
        **evallib.trajectory_errors(pose, gt_r).as_dict(),
        "reprojection_rmse_px": evallib.reprojection_rmse(
            pose, gt_r, intr, args.width, args.height, device=device
        ),
    })
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if args.plot:
        from ptzjax_torch.plots import plot_run

        plot_run(pose, gt_r, os.path.join(args.out, "trajectory.png"), records=records, title=title)
    print(json.dumps(summary, indent=2))


def run_offline(args: argparse.Namespace, inp: Inputs) -> RunResult:
    """Offline execution mode: (1) frame-parallel feature extraction over the
    mesh (``dist.extract_features_sharded``; descriptors zoom-normalized at
    the frame-0 focal, or at every frame's ground-truth focal with
    --oracle-focals), or the staged tables; (2) the tracking loop over
    chunks of ``--chunk`` frames, building the keyframe and ray stores; (3)
    ray-sharded BA over the map (``dist.run_sharded``; Huber IRLS when
    ``cfg.ba_huber_px > 0``), written back into the stores.

    Under ``torchrun`` every process joins the process group and the mesh:
    each extracts its block of frames and solves its block of rays, all run
    the tracking loop, and rank 0 writes the artifacts. ``summary["fps"]``
    is (frames - 1) over the frontend's and the loop's seconds."""
    from ptzjax_torch import dist, mapstore

    os.makedirs(args.out, exist_ok=True)
    device = _device.resolve(args.device)
    cfg, intr, gt = inp.cfg, inp.intr, inp.gt
    print(f"device: {device}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not torch.distributed.is_initialized():
        dist.initialize_multihost(backend="nccl" if device.type == "cuda" else "gloo")
    mesh = dist.make_mesh(args.mesh_devices or None)
    if device.type == "cuda":
        from ptzjax_torch.kernels import _build

        _build.load()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    if inp.feats is None:
        n = len(inp.imgs)
        # the product path anchors the descriptor scale on the frame-0 focal
        # only (what the bootstrap knows); per-frame focals are ground truth
        focals = gt[:n, 2] if args.oracle_focals else np.full((n,), gt[0, 2])
        xy_all, desc_all, valid_all = dist.extract_features_sharded(
            inp.imgs, cfg, mesh, masks=inp.masks, focals=focals.astype(np.float32), device=device
        )
    else:
        xy_all, desc_all, valid_all = _stacked(inp.feats, device)
    sync()
    t_frontend = time.perf_counter() - t0

    slam = PTZSlam(cfg, intr, device=device)
    state = slam.init(xy_all[0], desc_all[0], valid_all[0], gt[0])
    total = len(xy_all)
    chunk = max(1, args.chunk)
    pending = []
    t1 = time.perf_counter()
    for k in range(1, total, chunk):
        end = min(k + chunk, total)    # the last chunk runs short
        state, infos = slam.run_segment(state, xy_all[k:end], desc_all[k:end], valid_all[k:end])
        pending.append((k, infos))
    sync()
    t_track = time.perf_counter() - t1
    records = [r for k, infos in pending for r in infos_to_dicts(infos, frame0=k)]

    t2 = time.perf_counter()
    prob = mapstore.build_ba_problem(state.kf, state.rays, max_views_per_ray=cfg.ba_max_views_per_ray)
    res = dist.run_sharded(prob, intr, cfg, mesh)
    m = prob.rays.shape[0]
    kf, rays = mapstore.apply_ba_result(state.kf, state.rays, res.cams, res.rays[:m], prob.obs_w)
    state = state._replace(kf=kf, rays=rays)
    sync()
    t_ba = time.perf_counter() - t2
    ba_info = {"ba_cost_before": float(res.initial_cost), "ba_cost_after": float(res.cost)}

    pose = np.stack([r["pose"] for r in records])
    gt_r = gt[np.array([r["frame"] for r in records])]
    summary = {
        "fps": (total - 1) / (t_frontend + t_track),
        "frames_lost": sum(r["lost"] for r in records),
        "keyframes": sum(r["keyframe"] for r in records),
        "mode": "offline",
        "frontend_focals": (
            "precomputed" if inp.feats is not None
            else ("oracle_per_frame_gt" if args.oracle_focals else "f_ref_frame0")
        ),
        "mesh_devices": mesh.size,
        "frontend_s": t_frontend,
        "tracking_s": t_track,
        "ba_s": t_ba,
        **ba_info,
        "ba_robust": cfg.ba_huber_px > 0,
    }
    if mesh.rank == 0:
        title = f"{os.path.basename(args.out.rstrip('/'))} (offline)"
        _write_artifacts(args, records, pose, gt_r, intr, device, summary, title)
    return RunResult(summary, records, ba_info, state, [])


def run_homography_baseline(args: argparse.Namespace, inp: Inputs) -> RunResult:
    """The baseline tracker over the staged feature tables
    (``baselines.track_homography_ekf``), with the SLAM path's artifacts.
    ``summary["fps"]`` times the tracking only: the tables are staged, and
    the kernel library loaded, before the clock."""
    from ptzjax_torch.baselines import init_vo, track_homography_ekf

    os.makedirs(args.out, exist_ok=True)
    device = _device.resolve(args.device)
    print(f"device: {device}")
    if device.type == "cuda":
        from ptzjax_torch.kernels import _build

        _build.load()
    cfg, intr, gt = inp.cfg, inp.intr, inp.gt
    xy, desc, valid = _stacked(inp.feats, device)
    state = init_vo(gt[0], xy[0], desc[0], valid[0], cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, infos = track_homography_ekf(state, xy[1:], desc[1:], valid[1:], intr=intr, cfg=cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    pose = infos.pose.cpu().numpy()
    n_inl = infos.num_inliers.cpu().numpy()
    updated = infos.updated.cpu().numpy()
    records = [
        {
            "frame": k + 1, "event": "track", "pose": pose[k], "num_matches": int(n_inl[k]),
            "lost": not bool(updated[k]), "keyframe": False,
        }
        for k in range(len(pose))
    ]
    summary = {
        "fps": len(pose) / wall,
        "frames_lost": sum(r["lost"] for r in records),
        "tracker": "homography",
    }
    title = f"{os.path.basename(args.out.rstrip('/'))} (homography baseline)"
    _write_artifacts(args, records, pose, gt[1 : len(pose) + 1], intr, device, summary, title)
    return RunResult(summary, records, None, state, [])


def main(argv: list[str] | None = None) -> RunResult:
    args = parse_args(argv)
    _device.resolve(args.device)   # no card and no --device cpu: raise before any work
    inp = assemble(args)
    if args.offline:
        return run_offline(args, inp)
    if args.tracker == "homography":
        return run_homography_baseline(args, inp)
    return run_sequence(args, inp)


if __name__ == "__main__":
    main()
