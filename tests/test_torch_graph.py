"""The split tracked step (``slam._track_step``) and the CUDA-graph loop
(``ptzjax_torch/_graphs.py``) on the CPU, at 320 x 180 with 32 EKF slots,
on a 24-frame sequence with two keyframe inserts (frames 8 and 17) and a
blackout (frames 14-15: lost, relocalized at 16).

The capture itself needs the card (``tests/test_torch_cuda.py``); here the
graph loop runs its frame program eagerly, the conditions read on the
host, which checks everything around the capture: the state buffers, the
write-back, the insert and lost branches, the skipped frames and the
returned state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.frontend import extract_features as j_extract
from ptzjax.geometry import Intrinsics
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import _graphs
from ptzjax_torch import frontend as tfront
from ptzjax_torch import mapstore
from ptzjax_torch import slam as tslam
from ptzjax_torch.checkpoint import tree_flatten
from ptzjax_torch.kernels import harris_nms, match
from tests._torch_port import n, port_cfg, port_intr, t

torch.set_num_threads(2)

W, H = 320, 180
FRAMES = 24
BLACKOUT = (14, 15)


@pytest.fixture(scope="module")
def seq():
    """(frames with the blackout zeroed, cameras, intrinsics)."""
    pano = synth.make_panorama(
        theta_range=(-0.6, 0.6), phi_range=(-0.35, 0.2), texels_per_rad=1100.0, seed=1
    )
    cams = synth.make_trajectory(
        FRAMES, pan_amp=0.12, tilt0=-0.05, tilt_amp=0.02, f0=550.0, f_amp=30.0,
        period=FRAMES * 1.6, seed=1,
    )
    intr = Intrinsics.create(W / 2.0, H / 2.0)
    imgs = np.stack([synth.render_image(pano, c, intr, W, H) for c in cams])
    imgs[list(BLACKOUT)] = 0.0
    return imgs, cams, intr


def _cfg(mode: str = "map") -> SLAMConfig:
    return SLAMConfig(
        image_width=W, image_height=H, max_keypoints=128, max_rays=32, max_map_rays=512,
        max_keyframes=8, kf_desc_dim=128, sigma_obs=1.0, min_inliers=8, keyframe_interval=8,
        reloc_mode=mode,
    )


def _masks() -> np.ndarray:
    m = np.ones((FRAMES, H, W), bool)
    m[:, 40:90, 60:130] = False
    return m


def _start(seq, mode="map"):
    imgs, cams, intr = seq
    slam = tslam.PTZSlam(port_cfg(_cfg(mode)), port_intr(intr), device="cpu")
    state = slam.init(*tfront.extract_features(t(imgs[0]), slam.cfg), cams[0])
    return slam, state


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Float32 as its bits, so that NaN garbage compares equal to itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


# (a) no host read in the captured step ---------------------------------------


class NoHostRead(TorchDispatchMode):
    """Fails on every op that makes the host wait for the card, or copies
    host data to it, inside a CUDA-graph capture: a scalar read, the ops
    whose output size depends on the data, a tensor made from host data,
    and indexing with a bool mask (a nonzero inside)."""

    FORBIDDEN = (
        "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten._unique",
        "aten.unique", "aten.lift_fresh", "aten.repeat_interleave",
    )

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.FORBIDDEN):
            raise AssertionError(f"host read in the captured step: {name}")
        if name.startswith(("aten.index.", "aten.index_put")):
            indices = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in indices):
                raise AssertionError(f"bool-mask indexing in the captured step: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_captured_step_makes_no_host_read(seq, mode, masked):
    """What a ``TrackGraph`` captures -- the frontend, ``_track_step`` and
    the write-back -- runs under a dispatch mode that fails on any host read
    (after one warm-up frame, as on the card, which makes the cached
    constants)."""
    imgs, cams, _ = seq
    slam, state = _start(seq, mode)
    g = _graphs.TrackGraph(state, (H, W), masked, cfg=slam.cfg, intr=slam.intr, device=torch.device("cpu"))
    g.load(state)
    if masked:
        g.mask.copy_(torch.from_numpy(_masks()[1]))
    g.img.copy_(t(imgs[1]))
    g._step()
    g.img.copy_(t(imgs[2]))
    with NoHostRead():
        info, flags, _ = g._step()
    assert flags.shape == (2,) and flags.dtype == torch.bool
    assert not bool(info.lost) and int(info.num_matches) > 10


# (b) the split route is the route that read two flags a frame, bitwise -------


def _two_read_frame_step(state, xy, desc, valid, *, cfg, intr):
    """The frame step before the split: ``state.lost`` and the insert flag
    read on the host each frame."""
    if bool(state.lost):
        state, info, _ = tslam._relocalize(state, xy, desc, valid, cfg=cfg, intr=intr)
        return state, info
    s2, info = tslam._track_frame(state, xy, desc, valid, cfg=cfg, intr=intr)
    healthy = ~info.lost
    insert = healthy & (info.max_kf_overlap < cfg.keyframe_overlap)
    if cfg.keyframe_zoom_ratio > 1.0:
        insert = insert | (
            healthy & (mapstore.min_zoom_departure(s2.kf, s2.ekf.pose) > cfg.keyframe_zoom_ratio)
        )
    if cfg.keyframe_interval > 0:
        last_kf = torch.where(s2.kf.valid, s2.kf.frame_idx, -1).amax()
        insert = insert | (healthy & ((s2.frame_idx - last_kf) >= cfg.keyframe_interval))
    if bool(insert):
        s2 = tslam._insert_keyframe(s2, xy, desc, valid, cfg=cfg, intr=intr)
        if cfg.online_ba_iters > 0 and bool(s2.kf.count >= 2):
            s2 = tslam._windowed_ba(s2, cfg=cfg, intr=intr)
    return s2, info._replace(keyframe=insert)


def _two_read_run(state, frames, *, cfg, intr):
    infos = []
    for img in frames:
        xy, desc, valid = tfront.extract_features(img, cfg, focal=tslam._safe_focal(state, cfg))
        state, info = _two_read_frame_step(state, xy, desc, valid, cfg=cfg, intr=intr)
        infos.append(info)
    return state, tslam._stack(infos)


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_split_route_is_the_two_read_route_bitwise(seq, mode):
    """``run_segment_pixels`` on the CPU (the split ``_frame_step``, with the
    lost flag carried from the frame before, across three calls) gives
    bitwise the states and infos of the route that read ``state.lost`` and
    the insert flag every frame."""
    imgs, _, _ = seq
    frames = t(imgs)
    slam, state = _start(seq, mode)
    want_state, want = _two_read_run(state, frames[1:], cfg=slam.cfg, intr=slam.intr)
    infos = []
    for a, b in ((1, 6), (6, 15), (15, FRAMES)):
        state, part = slam.run_segment_pixels(state, frames[a:b])
        infos.append(part)
    got = tslam.FrameInfo(*(torch.cat(f) for f in zip(*infos)))
    assert _same(got, want) and _same(state, want_state)
    # the sequence took every branch: inserts, lost frames, a failed and a
    # successful relocalization
    assert n(want.keyframe).sum() >= 2 and n(want.event).tolist().count(1) >= 2
    assert n(want.reloc_success).any() and not n(want.reloc_success)[n(want.event) == 1].all()


# (c) the step writes into no tensor it was given -----------------------------


def test_track_step_writes_into_no_input(seq):
    """``_track_step`` leaves every tensor it was given as it was (values and
    version counters), over the tracked frames before the blackout, the
    keyframe insert's frame included."""
    imgs, _, _ = seq
    slam, state = _start(seq)
    cfg, intr = slam.cfg, slam.intr
    for k in range(1, BLACKOUT[0]):
        xy, desc, valid = tfront.extract_features(t(imgs[k]), cfg, focal=tslam._safe_focal(state, cfg))
        given = tree_flatten(state)[0] + [xy, desc, valid]
        before = [(x._version, x.clone()) for x in given]
        s2, info, flags = tslam._track_step(state, xy, desc, valid, cfg=cfg, intr=intr)
        for x, (version, copy) in zip(given, before):
            assert x._version == version and torch.equal(_bits(x), _bits(copy)), k
        assert not bool(flags[0])
        state = s2 if not bool(flags[1]) else tslam._keyframe(s2, xy, desc, valid, cfg=cfg, intr=intr)[0]


# (d) the launch counters ------------------------------------------------------


def test_counter_credit_adds_the_captured_rise_once_per_replay(monkeypatch):
    """Pure Python: a capture's rise of the launch counters is undone and
    returned, and each ``credit`` adds it once."""
    for mod, name in _graphs.COUNTERS:
        monkeypatch.setattr(mod, name, 7)

    def capture():
        harris_nms.launches += 1
        harris_nms.masked_launches += 1
        match.launches += 2

    rise = _graphs.captured_rise(capture)
    assert rise == (1, 1, 0, 2, 0, 0, 0, 0)
    assert all(getattr(mod, name) == 7 for mod, name in _graphs.COUNTERS)
    for _ in range(3):
        _graphs.credit(rise)
    assert [getattr(mod, name) for mod, name in _graphs.COUNTERS] == [10, 10, 7, 13, 7, 7, 7, 7]


def test_failed_capture_leaves_the_counters(monkeypatch):
    """A capture that raises puts the counters back and the error through."""
    for mod, name in _graphs.COUNTERS:
        monkeypatch.setattr(mod, name, 0)

    def capture():
        match.launches += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _graphs.captured_rise(capture)
    assert all(getattr(mod, name) == 0 for mod, name in _graphs.COUNTERS)


# (e) the split route against the reference's frame step ---------------------


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_split_route_holds_against_reference_frame_step(seq, mode):
    """The port's ``_frame_step`` (through ``PTZSlam.step``) and
    ``ptzjax``'s jitted ``_frame_step`` (through ``PTZSlam.process``) on the
    same features of every frame, from the same bootstrap, at
    ``test_torch_slice.py``'s tolerances: flags equal, matches within 2,
    poses within 5e-4 rad and 2 px."""
    imgs, cams, intr = seq
    cfg = _cfg(mode).replace(descriptor_f_ref=0.0)   # fixed descriptor spacing: features shared
    feats = [tuple(np.asarray(v) for v in j_extract(jnp.asarray(im), cfg, use_pallas=False)) for im in imgs]
    jslam = JaxSlam(cfg, intr)
    jstate = jslam.init(*feats[0], cams[0])
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    state = slam.init(*(t(v) for v in feats[0]), cams[0])
    ref, got = [], []
    for k in range(1, FRAMES):
        jstate, jinfo = jslam._step(jstate, *(jnp.asarray(v) for v in feats[k]))
        state, info = slam.step(state, *(t(v) for v in feats[k]))
        ref.append(jax.device_get(jinfo))
        got.append(info)
    for key in ("lost", "event", "keyframe", "reloc_success"):
        assert [bool(getattr(i, key)) if key != "event" else int(i.event) for i in got] == [
            bool(getattr(i, key)) if key != "event" else int(i.event) for i in ref
        ], key
    matches = np.array([int(i.num_matches) for i in got]) - np.array([int(i.num_matches) for i in ref])
    assert np.abs(matches).max() <= 2
    dpose = np.abs(np.stack([n(i.pose) for i in got]) - np.stack([np.asarray(i.pose) for i in ref]))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    assert sum(bool(i.keyframe) for i in got) >= 2 and any(bool(i.reloc_success) for i in got)


# the graph loop around the capture ------------------------------------------


def host_cond(pred, then, otherwise=None) -> None:
    """The frame program's ``cond`` on the CPU: ``pred`` read on the host
    outside every dispatch mode (so that ``NoHostRead`` and the read counts
    see only the program's own reads), and ``then`` or ``otherwise`` run."""
    with _disable_current_modes():
        holds = bool(pred)
    if holds:
        then()
    elif otherwise is not None:
        otherwise()


@pytest.fixture
def eager_replays(monkeypatch):
    """Every capture replaced by eager replays on the CPU: the same work,
    without a capture. A ``TrackGraph``'s frame program keeps its warm-up
    (every branch on a copy of the buffers, put back) and each launch runs
    ``TrackGraph._frame`` with ``host_cond``; a ``Program`` (the baseline's)
    runs its first use and replays eagerly. Each counts its replays in
    ``replays``."""

    def capture(self, owner):
        self.replays = 0
        self.rise = {name: (0,) * len(_graphs.COUNTERS) for name in _graphs.BRANCHES}

        def replay():
            owner._frame(host_cond, owner._branch)
            self.replays += 1

        self.replay = replay

    def first_use(self, owner):
        out = self.fn(owner)
        self.replays = 0

        def replay():
            self._out = self.fn(owner)
            self.replays += 1

        self.replay = replay
        self._rise = (0,) * len(_graphs.COUNTERS)
        return out

    monkeypatch.setattr(_graphs.FrameProgram, "capture", capture)
    monkeypatch.setattr(_graphs.Program, "first_use", first_use)


def _graph_slam(seq, mode):
    slam, state = _start(seq, mode)
    slam._graphs = _graphs.Runner(torch.device("cpu"))
    return slam, state


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_graph_loop_matches_the_eager_route(seq, eager_replays, mode, masked):
    """The graph loop (tracked, insert and lost frames through the state
    buffers, skipped frames) gives bitwise the eager
    route's states and infos, over calls of one frame and of several, and
    leaves the caller's state as it was."""
    imgs, _, _ = seq
    frames = t(imgs)
    masks = torch.from_numpy(_masks()) if masked else None
    ok = np.ones(FRAMES, bool)
    ok[5] = False
    runs = {}
    for route in ("graph", "eager"):
        slam, state = _graph_slam(seq, mode) if route == "graph" else _start(seq, mode)
        first = state
        kept = _graphs._clone(first)
        infos = []
        for a, b in ((1, 2), (2, 9), (9, 10), (10, FRAMES)):
            state, part = slam.run_segment_pixels(
                state, frames[a:b], None if masks is None else masks[a:b], frame_ok=ok[a:b]
            )
            infos.append(part)
        assert _same(first, kept)
        runs[route] = (state, tslam.FrameInfo(*(torch.cat(f) for f in zip(*infos))))
    (s_g, i_g), (s_e, i_e) = runs["graph"], runs["eager"]
    assert _same(i_g, i_e) and _same(s_g, s_e)
    assert n(i_e.event).tolist().count(2) == 1 and n(i_e.keyframe).sum() >= 2 and n(i_e.reloc_success).any()


def test_graph_loop_rewound_state_replays_the_same(seq, eager_replays):
    """The forest's rewind: a state kept from before a call, run again
    through the same graph, gives bitwise the first run's result."""
    imgs, _, _ = seq
    frames = t(imgs)
    slam, state = _graph_slam(seq, "map")
    mid, _ = slam.run_segment_pixels(state, frames[1:6])
    end, infos = slam.run_segment_pixels(mid, frames[6:12])
    again, infos2 = slam.run_segment_pixels(mid, frames[6:12])
    assert _same(end, again) and _same(infos, infos2)


def test_graph_refuses_a_state_of_another_config(seq):
    """A state whose fields do not fit the graph's buffers raises."""
    slam, state = _start(seq)
    g = _graphs.TrackGraph(state, (H, W), False, cfg=slam.cfg, intr=slam.intr, device=torch.device("cpu"))
    other = state._replace(slot_desc=torch.zeros(64, 128))
    with pytest.raises(ValueError, match="does not fit"):
        g.load(other)


def test_lost_flag_of_the_returned_state_is_not_read_again(seq):
    """The next call's first frame takes the lost flag from the frame that
    made the state: no scalar read for a state this object returned, one
    for any other."""
    imgs, _, _ = seq
    slam, state = _start(seq)
    state, _ = slam.run_segment_pixels(state, t(imgs[1:3]))

    class Reads(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Reads.count += str(func).startswith("aten._local_scalar_dense")
            return func(*args, **(kwargs or {}))

    with Reads():
        assert slam._lost_of(state) is False
    assert Reads.count == 0
    with Reads():
        assert slam._lost_of(state._replace(lost=torch.ones((), dtype=torch.bool))) is True
    assert Reads.count == 1
