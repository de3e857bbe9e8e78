"""The CUDA-graph loops of KLT mode (``run_segment_pixels_klt``) and of
features mode (``run_segment`` and ``step``) (``ptzjax_torch/_graphs.py``)
on the CPU, on ``test_torch_graph.py``'s 24-frame 320 x 180 sequence: two
keyframe inserts (frames 8 and 17), a blackout (frames 14-15: lost,
relocalized at 16 in map mode, 17 in keyframe mode).

The capture itself needs the card (``tests/test_torch_cuda.py``); here the
graph loops run their frame program eagerly (``eager_replays``), which
checks everything around the capture: the state and carry buffers, the
write-back and the carry's tail, the insert and lost branches, the skipped
frames and the returned state and carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax.frontend import extract_features as j_extract
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import _graphs
from ptzjax_torch import frontend as tfront
from ptzjax_torch import slam as tslam
from tests._torch_port import n, port_cfg, port_intr, t
from tests.test_torch_graph import FRAMES, H, W, NoHostRead, _cfg, _masks, _same, eager_replays, seq  # noqa: F401

torch.set_num_threads(2)

CPU = torch.device("cpu")
# the calls a run is cut into (frames [a, b)), and the frame it skips
CALLS = ((1, 2), (2, 9), (9, 10), (10, FRAMES))
SKIPPED = 5


def _slam(seq, mode: str, graphs: bool):
    """A CPU ``PTZSlam`` bootstrapped on frame 0 (with the graph route's
    ``Runner`` where ``graphs``), its state and frame 0's (xy, valid)."""
    imgs, cams, intr = seq
    slam = tslam.PTZSlam(port_cfg(_cfg(mode)), port_intr(intr), device="cpu")
    xy0, desc0, valid0 = tfront.extract_features(t(imgs[0]), slam.cfg)
    state = slam.init(xy0, desc0, valid0, cams[0])
    if graphs:
        slam._graphs = _graphs.Runner(CPU)
    return slam, state, xy0, valid0


@pytest.fixture(scope="module")
def feats(seq):
    """Every frame's re-detect features, stacked (T, K, ...)."""
    imgs = seq[0]
    cfg = port_cfg(_cfg())
    out = [tfront.extract_features(t(im), cfg) for im in imgs]
    return tuple(torch.stack([f[i] for f in out]) for i in range(3))


def _frame_ok() -> np.ndarray:
    ok = np.ones(FRAMES, bool)
    ok[SKIPPED] = False
    return ok


def _kept(*trees):
    return [_graphs._clone(x) if isinstance(x, tuple) else x.clone() for x in trees]


def _untouched(given, kept) -> bool:
    return all(_same(a, b) if isinstance(a, tuple) else torch.equal(a, b) for a, b in zip(given, kept))


def _klt_run(seq, mode, masked, graphs):
    """KLT mode over CALLS, each call seeded with the carry the last one
    returned (the previous chunk's last frame, as ``run.py`` seeds it):
    (final state, infos, every call's returned (xy, valid))."""
    imgs, _, _ = seq
    frames = t(imgs)
    masks = torch.from_numpy(_masks()) if masked else None
    ok = _frame_ok()
    slam, state, xy, valid = _slam(seq, mode, graphs)
    infos, carries = [], []
    for a, b in CALLS:
        given = (state, xy, valid)
        kept = _kept(*given)
        state, part, xy, valid = slam.run_segment_pixels_klt(
            state, frames[a:b], frames[a - 1], xy, valid, frame_ok=ok[a:b],
            masks=None if masks is None else masks[a:b],
        )
        assert _untouched(given, kept)
        infos.append(part)
        carries.append((xy, valid))
    return state, tslam.FrameInfo(*(torch.cat(f) for f in zip(*infos))), carries


# (a) the KLT graph loop is the eager route, bitwise ----------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_klt_graph_loop_matches_the_eager_route(seq, eager_replays, mode, masked):
    """The KLT graph loop (tracked frames through the state and carry
    buffers, insert and lost branches, a skipped frame) gives
    bitwise the eager route's states, infos and returned carry, over calls
    of one frame and of several, and leaves the caller's state and carry as
    they were."""
    s_g, i_g, c_g = _klt_run(seq, mode, masked, graphs=True)
    s_e, i_e, c_e = _klt_run(seq, mode, masked, graphs=False)
    assert _same(i_g, i_e) and _same(s_g, s_e)
    assert all(torch.equal(a, b) for cg, ce in zip(c_g, c_e) for a, b in zip(cg, ce))
    assert n(i_e.event).tolist().count(2) == 1 and n(i_e.keyframe).sum() >= 2 and n(i_e.reloc_success).any()


def test_klt_graph_carries_the_table_of_the_last_real_frame(seq, eager_replays):
    """A call whose every frame is skipped returns the caller's table (as
    fresh tensors); one whose last frame is skipped returns the last real
    frame's, as the eager route does."""
    imgs, _, _ = seq
    frames = t(imgs)
    out = {}
    for graphs in (True, False):
        slam, state, xy0, v0 = _slam(seq, "map", graphs)
        _, _, xy, valid = slam.run_segment_pixels_klt(state, frames[1:3], frames[0], xy0, v0, frame_ok=[False, False])
        assert torch.equal(xy, xy0) and torch.equal(valid, v0)
        if graphs:
            assert xy is not xy0 and valid is not v0
        out[graphs] = slam.run_segment_pixels_klt(
            state, frames[1:4], frames[0], xy0, v0, frame_ok=[True, True, False]
        )[2:]
    assert all(torch.equal(a, b) for a, b in zip(out[True], out[False]))


# (b) run_segment and step are the eager route, bitwise -------------------------


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_run_segment_graph_loop_matches_the_eager_route(seq, feats, eager_replays, mode):
    """``run_segment`` on the graph route over CALLS (a skipped frame
    included) gives bitwise the eager route's states and infos, and leaves
    the caller's state as it was."""
    ok = _frame_ok()
    runs = {}
    for graphs in (True, False):
        slam, state, _, _ = _slam(seq, mode, graphs)
        infos = []
        for a, b in CALLS:
            given, kept = state, _graphs._clone(state)
            state, part = slam.run_segment(state, *(f[a:b] for f in feats), frame_ok=ok[a:b])
            assert _same(given, kept)
            infos.append(part)
        runs[graphs] = state, tslam.FrameInfo(*(torch.cat(f) for f in zip(*infos)))
    (s_g, i_g), (s_e, i_e) = runs[True], runs[False]
    assert _same(i_g, i_e) and _same(s_g, s_e)
    assert n(i_e.event).tolist().count(2) == 1 and n(i_e.keyframe).sum() >= 2 and n(i_e.reloc_success).any()


def _host_dict_bits(d: dict) -> dict:
    return {k: v.view(np.int32).tolist() if k == "pose" else v for k, v in d.items()}


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_step_graph_route_matches_the_eager_route(seq, feats, eager_replays, mode):
    """``step`` one frame a call on the graph route (every third frame
    through ``process``, which calls it with numpy inputs) gives bitwise the
    eager route's states and infos, and leaves the caller's state as it
    was."""
    runs = {}
    for graphs in (True, False):
        slam, state, _, _ = _slam(seq, mode, graphs)
        out = []
        for k in range(1, FRAMES):
            given, kept = state, _graphs._clone(state)
            if k % 3:
                state, info = slam.step(state, *(f[k] for f in feats))
            else:
                state, info = slam.process(state, *(n(f[k]) for f in feats))
                info = _host_dict_bits(info)
            assert _same(given, kept)
            out.append(info)
        runs[graphs] = state, out
    (s_g, i_g), (s_e, i_e) = runs[True], runs[False]
    assert _same(s_g, s_e)
    assert all(a == b if isinstance(a, dict) else _same(a, b) for a, b in zip(i_g, i_e))
    events = [int(i.event) for i in i_e if not isinstance(i, dict)]
    assert events.count(1) >= 1 and sum(bool(i.keyframe) for i in i_e if not isinstance(i, dict)) >= 1


# (c) no host read in what the KLT and features graphs capture -----------------


@pytest.mark.parametrize("kind, masked", [("klt", False), ("klt", True), ("features", False)])
def test_captured_klt_and_features_steps_make_no_host_read(seq, feats, kind, masked):
    """What a KLT or features ``TrackGraph`` captures -- the frontend (LK,
    the refill and the descriptors; none for features), ``_track_step``, the
    write-back and the carry's tail -- runs under a dispatch mode that
    fails on any host read, after one warm-up frame, as on the card."""
    imgs, _, _ = seq
    slam, state, xy0, v0 = _slam(seq, "map", False)
    if kind == "klt":
        g = _graphs.TrackGraph(
            state, (H, W), masked, cfg=slam.cfg, intr=slam.intr, device=CPU, kind="klt", carry_rows=xy0.shape[0]
        )
        g.load(state, carry=(t(imgs[0]), xy0, v0))
        frame = [(t(imgs[k]), torch.from_numpy(_masks()[k]) if masked else None) for k in (1, 2)]
    else:
        g = _graphs.TrackGraph(state, tuple(feats[1].shape[1:]), cfg=slam.cfg, intr=slam.intr, device=CPU, kind="features")
        g.load(state)
        frame = [tuple(f[k] for f in feats) for k in (1, 2)]

    def fill(inputs):
        for dst, src in zip(g.inputs, inputs):
            if dst is not None:
                dst.copy_(src)

    fill(frame[0])
    g._step()
    fill(frame[1])
    with NoHostRead():
        info, flags, _ = g._step()
    assert flags.shape == (2,) and flags.dtype == torch.bool
    assert not bool(info.lost) and int(info.num_matches) > 10
    if kind == "klt":   # the tail moved the carry on to frame 2
        assert torch.equal(g.carry[0], t(imgs[2])) and int(g.carry[2].sum()) > 50


# (d) a rewound state replays the same through each kind -----------------------


@pytest.mark.parametrize("kind", ["klt", "features", "step"])
def test_rewound_state_replays_the_same(seq, feats, eager_replays, kind):
    """The forest's rewind: a state (and carry) kept from before a call, run
    again through the same graph, gives bitwise the first run's result."""
    imgs, _, _ = seq
    frames = t(imgs)
    slam, state, xy, valid = _slam(seq, "map", True)

    def run(state, a, b, xy=None, valid=None):
        if kind == "klt":
            return slam.run_segment_pixels_klt(state, frames[a:b], frames[a - 1], xy, valid)
        if kind == "features":
            return slam.run_segment(state, *(f[a:b] for f in feats))
        out = []
        for k in range(a, b):
            state, info = slam.step(state, *(f[k] for f in feats))
            out.append(info)
        return state, tslam._stack(out)

    mid = run(state, 1, 6, xy, valid)
    end = run(mid[0], 6, 12, *mid[2:])
    again = run(mid[0], 6, 12, *mid[2:])
    assert all(_same(a, b) if isinstance(a, tuple) else torch.equal(a, b) for a, b in zip(end, again))


# (e) a state or carry that does not fit raises --------------------------------


def test_klt_and_features_graphs_refuse_what_does_not_fit(seq, feats, eager_replays):
    """A state of another config, a carry table of another K or an image of
    another shape raises, on the KLT and on the features graph, as does an
    unknown kind."""
    imgs, _, _ = seq
    frames = t(imgs)
    slam, state, xy0, v0 = _slam(seq, "map", True)
    slam.run_segment_pixels_klt(state, frames[1:2], frames[0], xy0, v0)
    slam.run_segment(state, *(f[1:2] for f in feats))
    other = state._replace(slot_desc=torch.zeros(64, 128))
    for call in (
        lambda: slam.run_segment_pixels_klt(other, frames[1:2], frames[0], xy0, v0),
        lambda: slam.run_segment_pixels_klt(state, frames[1:2], frames[0], xy0[:64], v0[:64]),
        lambda: slam.run_segment_pixels_klt(state, frames[1:2], frames[0], xy0.double(), v0),
        lambda: slam.run_segment_pixels_klt(state, frames[1:2], frames[0, :90], xy0, v0),
        lambda: slam.run_segment(other, *(f[1:2] for f in feats)),
        lambda: slam.step(other, *(f[1] for f in feats)),
    ):
        with pytest.raises(ValueError, match="does not fit"):
            call()
    with pytest.raises(ValueError, match="kind"):
        _graphs.TrackGraph(state, (H, W), cfg=slam.cfg, intr=slam.intr, device=CPU, kind="homography")
    assert {k[0] for k in slam._graphs.graphs} == {"klt", "features"}


# (f) the graph KLT loop against the reference ---------------------------------


def test_klt_graph_loop_holds_against_the_reference(seq, eager_replays):
    """The graph KLT loop and ``ptzjax``'s ``run_segment_pixels_klt`` over
    the 23 frames after ``init`` (both inserts, the blackout and its
    relocalization), each seeded with its own frame-0 features, at
    ``test_torch_klt.py``'s tolerances: flags equal, poses within 5e-4 rad
    and 2 px, the final table's valid rows equal and within 1e-3 px."""
    imgs, cams, intr = seq
    cfg = _cfg("map")
    jslam = JaxSlam(cfg, intr)
    xy0, d0, v0 = j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False)
    jstate = jslam.init(xy0, d0, v0, cams[0])
    _, jinfos, jxy, jvalid = jslam.run_segment_pixels_klt(
        jstate, jnp.asarray(imgs[1:]), jnp.asarray(imgs[0]), xy0, v0, use_pallas=False
    )
    jinfos, jxy, jvalid = jax.device_get(jinfos), np.asarray(jxy), np.asarray(jvalid)
    slam, state, xy, valid = _slam(seq, "map", True)
    _, infos, xy, valid = slam.run_segment_pixels_klt(state, t(imgs[1:]), t(imgs[0]), xy, valid)
    for key in ("lost", "event", "keyframe", "reloc_success"):
        np.testing.assert_array_equal(n(getattr(infos, key)), np.asarray(getattr(jinfos, key)), err_msg=key)
    dpose = np.abs(n(infos.pose) - np.asarray(jinfos.pose))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    np.testing.assert_array_equal(n(valid), jvalid)
    np.testing.assert_allclose(n(xy)[jvalid], jxy[jvalid], atol=1e-3, rtol=0)
    assert n(infos.keyframe).sum() >= 2 and n(infos.reloc_success).any()
