"""The locked prefix: where the reference's own innovation shows a lock
lost on both sides, the poses after it are not compared, so that a
rounding magnified there does not read as a fault; the program's own
innovation never shortens the comparison."""

from __future__ import annotations

import pytest
import torch

from ptzbench import check


def _infos(pan, innovation, lost=None):
    from ptzbench.reference.slam import FrameInfo

    n = len(pan)
    pose = torch.tensor([[p, -0.05, 2000.0] for p in pan], dtype=torch.float32)
    z = torch.zeros(n)
    lost = torch.tensor(lost if lost is not None else [False] * n)
    return FrameInfo(pose, z, z, torch.tensor(innovation, dtype=torch.float32), lost, z, z,
                     torch.zeros(n, dtype=torch.int64), z, z)


def _end():
    from ptzbench.reference.config import SLAMConfig
    from ptzbench.reference.mapstore import init_keyframe_store, init_ray_store
    from ptzbench.reference.slam import SlamState

    cfg = SLAMConfig(max_keyframes=2, max_keypoints=4, max_map_rays=4, kf_desc_dim=2)
    return SlamState(None, None, init_keyframe_store(cfg), init_ray_store(cfg), None, None)


CALM, LOST_AT, N = 0.2, 4, 10


def _lock_lost_on_both_sides():
    """Frames 0-3 alike; from frame 4 the reference's innovation climbs past
    LOCK_PX and the two sides part by 2e-3 rad; no side reports a loss."""
    pan = [0.1 + 1e-3 * i for i in range(N)]
    innov = [CALM] * LOST_AT + [4.0] * (N - LOST_AT)
    prog = _infos([p + (2e-3 if i >= LOST_AT else 0.0) for i, p in enumerate(pan)], innov)
    return prog, _infos(pan, innov)


def test_a_lock_lost_on_both_sides_ends_the_compared_poses():
    prog, ref = _lock_lost_on_both_sides()
    end = _end()
    got = check.compare(prog, ref, end, end)
    assert got["_calm_frames"] == N and got["_locked_frames"] == LOST_AT
    # six of ten frames part by 2e-3: over the calm prefix the median would read them
    assert got["pose_gap_p50_rad"] == 0.0 and got["_max_gap_rad"] == pytest.approx(2e-3, rel=1e-3)
    assert got["bad_frame_pct"] == 0.0


def test_gaps_in_the_locked_prefix_and_lost_flags_still_count():
    prog, ref = _lock_lost_on_both_sides()
    end = _end()
    # the first three frames shifted: inside the locked prefix, before the lock is lost
    shifted = prog._replace(pose=prog.pose + torch.tensor([[1e-2, 0.0, 0.0]] * 3 + [[0.0] * 3] * (N - 3)))
    got = check.compare(shifted, ref, end, end)
    assert got["pose_gap_p50_rad"] == pytest.approx(1e-2, rel=1e-3)
    assert got["step_gap_rad"] == pytest.approx(1e-2, rel=1e-3) and got["bad_frame_pct"] == pytest.approx(30.0)
    # a frame lost on one side counts after the lock is lost too
    lost = prog._replace(lost=torch.tensor([False] * (N - 1) + [True]))
    assert check.compare(lost, ref, end, end)["bad_frame_pct"] == pytest.approx(100 / N)


def test_only_the_reference_innovation_ends_the_locked_prefix():
    prog, ref = _lock_lost_on_both_sides()
    end = _end()
    calm_ref = ref._replace(innovation_rms=torch.full((N,), CALM))
    # the program's innovation past LOCK_PX from frame 0 on: every frame still compared
    loud = prog._replace(innovation_rms=torch.full((N,), 10.0))
    got = check.compare(loud, calm_ref, end, end)
    assert got["_locked_frames"] == N and got["pose_gap_p50_rad"] == pytest.approx(2e-3, rel=1e-3)


def test_the_first_step_frames_never_end_the_locked_prefix():
    """A segment from the reference's bootstrap opens with a large
    innovation (the first update); the steps it compares stay in."""
    pan = [0.1] * N
    innov = [3.0] * check.STEP_FRAMES + [CALM] * (N - check.STEP_FRAMES)
    end = _end()
    got = check.compare(_infos([p + 1e-3 for p in pan], innov), _infos(pan, innov), end, end)
    assert got["_locked_frames"] == N and got["pose_gap_p50_rad"] == pytest.approx(1e-3, rel=1e-3)
    assert check.locked_frames(_infos(pan, [CALM] * N), 7) == 7
