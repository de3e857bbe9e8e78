"""ptzjax_torch parity on the CPU through the features entry points.
``PTZSlam.process`` across a blackout: tests/test_slam.py's occlusion
scenario (80 frames, frames 40-46 without features) goes lost, relocalizes
and recovers in the JAX package and in the port, in both ``reloc_mode``s,
from the same numpy features. ``PTZSlam.run_segment`` with padding
frames."""

import jax
import numpy as np
import pytest
import torch

from ptzjax.features import synth_features
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, t
from tests.test_slam import CFG, make_seq, pose_errors

torch.set_num_threads(2)

DROP = set(range(40, 47))


def _features(seq, cfg):
    """Per-frame (xy, desc, valid) as numpy, with the blackout applied."""
    out = []
    for k in range(len(seq.cameras)):
        f, _ = synth_features(seq, k, cfg.max_keypoints, noise_px=0.5, desc_noise=0.05)
        valid = np.asarray(f.valid) & (k not in DROP)
        out.append((np.asarray(f.xy), np.asarray(f.desc), valid))
    return out


def _run(slam, feats, pose0, init):
    state = slam.init(*init(feats[0]), pose0)
    infos = []
    for k in range(1, len(feats)):
        state, info = slam.process(state, *feats[k])
        info["frame"] = k
        infos.append(info)
    return infos


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_lost_and_recovered_matches_reference(mode):
    seq = make_seq(T=80)
    cfg = CFG.replace(reloc_mode=mode)
    feats = _features(seq, cfg)
    ref = _run(JaxSlam(cfg, seq.intr), feats, seq.cameras[0], lambda f: f)
    got = _run(
        tslam.PTZSlam(port_cfg(cfg), port_intr(seq.intr), device="cpu"), feats, seq.cameras[0],
        lambda f: tuple(t(v) for v in f),
    )
    for key in ("lost", "event", "reloc_success"):
        assert [i[key] for i in got] == [i[key] for i in ref], key
    assert any(i["reloc_success"] for i in got)
    dpose = np.abs(np.stack([i["pose"] for i in got]) - np.stack([i["pose"] for i in ref]))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)

    # the port alone meets tests/test_slam.py's ground-truth bounds
    by_frame = {i["frame"]: i for i in got}
    assert any(by_frame[k]["lost"] or by_frame[k]["event"] == "reloc" for k in DROP)
    tail = [i for i in got if i["frame"] >= 60]
    assert tail and all(i["event"] == "track" and not i["lost"] for i in tail)
    err, idx = pose_errors(seq, got)
    late = err[idx >= 60]
    assert late[:, 0].mean() < 2e-3 and late[:, 2].mean() < 30.0


def test_run_segment_matches_reference_with_padding():
    """``run_segment`` (a chunk of features at once) against the JAX
    package's ``lax.scan`` version, with padding frames (``frame_ok``
    False) that pass the state through, as in ``_run_segment_pixels``."""
    seq = make_seq(T=24)
    feats = _features(seq, CFG)
    xy, desc, valid = (np.stack([f[i] for f in feats[1:]]) for i in range(3))
    ok = np.ones(len(feats) - 1, bool)
    ok[[4, 5, 15]] = False
    jslam = JaxSlam(CFG, seq.intr)
    jstate = jslam.init(*feats[0], seq.cameras[0])
    jstate, ref = jax.device_get(jslam.run_segment(jstate, xy, desc, valid, frame_ok=ok))
    slam = tslam.PTZSlam(port_cfg(CFG), port_intr(seq.intr), device="cpu")
    state = slam.init(*(t(v) for v in feats[0]), seq.cameras[0])
    state, got = slam.run_segment(state, xy, desc, valid, frame_ok=ok)
    got = tslam.FrameInfo(*(n(v) for v in got))

    for key in ("event", "lost", "keyframe", "reloc_success"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.event.tolist().count(2) == 3 and int(state.frame_idx) == int(jstate.frame_idx)
    np.testing.assert_array_equal(got.pose[4], got.pose[3])    # padding passes the state through
    dpose = np.abs(got.pose - ref.pose)
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
