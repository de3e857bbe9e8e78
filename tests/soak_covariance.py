"""The filter covariance's smallest eigenvalue, frame by frame, along the
long soak's input (``ptzjax_torch.soak``: its periodic 720p stack at
``SLAMConfig(descriptor_f_ref=2000.0)``), from ``init`` on frame 0.

A frame is lost where the innovation covariance S = H P H^T + R is not
positive definite, so that its Cholesky factor fails and the update is a
one-frame no-op. That happens once P has a negative eigenvalue large
enough; this script shows how P's smallest eigenvalue (float64 of the
float32 state) moves, and S's on every frame that updates the filter:

    # the card, ptzjax_torch alone (the eager route, bitwise the graph
    # route the soak runs: the factor's input is read on the host)
    PYTHONPATH=. python tests/soak_covariance.py --card --frames 2600 --out card.jsonl

    # the CPU: ptzjax and ptzjax_torch on the same features (the port's
    # frontend makes them from the port's state), each package's own step
    PYTHONPATH=. python tests/soak_covariance.py --frames 800 --out cpu.jsonl

Each line of ``--out`` is one frame; the printout gives every 50th frame,
the frames around each lost one, and the lost frames of each run. The CPU
run takes ~0.3 s a frame and ~1.2 GB; the card run needs no jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ptzjax_torch import ekf as tekf
from ptzjax_torch import slam as tslam
from ptzjax_torch import soak, synth
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics

W, H, STACK = 1280, 720, 720


def lam_min(cov) -> float:
    return float(np.linalg.eigvalsh(np.asarray(cov, np.float64))[0])


class FactorInput:
    """Records the smallest eigenvalue of each matrix the EKF update hands
    to its Cholesky factor (S): ``ptzjax_torch.ekf.cholesky`` wrapped while
    the object is entered."""

    def __init__(self):
        self.s_lam_min = None

    def __enter__(self):
        self._orig = tekf.cholesky

        def spy(s):
            self.s_lam_min = float(torch.linalg.eigvalsh(s.double())[0])
            return self._orig(s)

        tekf.cholesky = spy
        return self

    def __exit__(self, *exc):
        tekf.cholesky = self._orig

    def take(self):
        value, self.s_lam_min = self.s_lam_min, None
        return value


def card_rows(frames: int):
    """ptzjax_torch on the card, one frame a call on the eager route
    (bitwise the graph route), the covariance read after each frame."""
    dev = torch.device("cuda")
    cams = soak.trajectory(STACK)
    imgs, intr = soak.render_stack(cams, W, H)
    imgs = torch.from_numpy(imgs).to(dev)
    cfg = SLAMConfig(descriptor_f_ref=2000.0)
    slam = tslam.PTZSlam(cfg, intr, device=dev, _graphs=False)
    state = slam.init(*extract_features(imgs[0], cfg, focal=torch.tensor(float(cams[0][2]), device=dev)), cams[0])
    with FactorInput() as factor:
        for t in range(frames):
            state, info = slam.run_segment_pixels(state, imgs[t % STACK][None])
            yield {
                "frame": t, "lost": bool(info.lost[0]), "event": int(info.event[0]),
                "lam_min": float(torch.linalg.eigvalsh(state.ekf.cov.double())[0]),
                "s_lam_min": factor.take(), "p_ff": float(state.ekf.cov[2, 2]),
            }


def cpu_rows(frames: int):
    """ptzjax and ptzjax_torch on the CPU from the same ``init``, each
    frame's features made once by the port's frontend (with the port's
    focal) and fed to both packages' ``_frame_step``."""
    from functools import partial

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ptzjax import slam as jslam
    from ptzjax.config import SLAMConfig as JaxConfig
    from ptzjax.geometry import Intrinsics as JaxIntrinsics

    torch.set_num_threads(4)
    jcfg = JaxConfig(descriptor_f_ref=2000.0)
    jintr = JaxIntrinsics.create(W / 2.0, H / 2.0)
    cfg, intr = SLAMConfig(**dataclasses.asdict(jcfg)), Intrinsics(*jintr)
    cams = soak.trajectory(STACK)
    pano = synth.make_panorama(seed=0)

    def frame(t):
        return torch.from_numpy(synth.render_image(pano, cams[t % STACK], intr, W, H).astype(np.float32))

    slam = tslam.PTZSlam(cfg, intr, device="cpu")
    feats = extract_features(frame(0), cfg, focal=torch.tensor(float(cams[0][2])))
    state = slam.init(*feats, cams[0])
    jstate = jslam.PTZSlam(jcfg, jintr).init(*(jnp.asarray(v.numpy()) for v in feats), cams[0])
    jstep = jax.jit(partial(jslam._frame_step, cfg=jcfg, intr=jintr))
    lost = False
    factor = FactorInput()
    for t in range(frames):
        xy, desc, valid = extract_features(frame(t), cfg, focal=tslam._safe_focal(state, cfg))
        with factor:
            state, info, lost = tslam._frame_step(state, xy, desc, valid, cfg=cfg, intr=intr, lost=lost)
        jstate, jinfo = jstep(jstate, *(jnp.asarray(v.numpy()) for v in (xy, desc, valid)))
        jinfo = jax.device_get(jinfo)
        yield {
            "frame": t, "lost": bool(info.lost), "event": int(info.event),
            "lam_min": lam_min(state.ekf.cov.numpy()), "s_lam_min": factor.take(), "p_ff": float(state.ekf.cov[2, 2]),
            "ref_lost": bool(jinfo.lost), "ref_event": int(jinfo.event),
            "ref_lam_min": lam_min(jstate.ekf.cov), "ref_p_ff": float(jstate.ekf.cov[2, 2]),
            "d_pose": np.abs(info.pose.numpy() - np.asarray(jinfo.pose)).tolist(),
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true", help="ptzjax_torch alone on the card")
    ap.add_argument("--frames", type=int, default=800)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = []
    with open(args.out, "w") as f:
        for r in (card_rows if args.card else cpu_rows)(args.frames):
            rows.append(r)
            f.write(json.dumps(r) + "\n")
    lost = {k: [r["frame"] for r in rows if r.get(k)] for k in ("lost", "ref_lost")}
    near = {L + d for k in lost.values() for L in k for d in range(-3, 2)}
    for r in rows:
        if r["frame"] % 50 == 0 or r["frame"] in near:
            print({k: v for k, v in r.items() if k != "d_pose"})
    print(f"lost frames: ptzjax_torch {lost['lost']}" + ("" if args.card else f", ptzjax {lost['ref_lost']}"))
    print(f"{args.frames} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
