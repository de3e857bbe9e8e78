"""The insert and lost branches of the CUDA-graph loops' frame program
(``ptzjax_torch/_graphs.py``: ``TrackGraph._branch`` "insert",
"insert+ba" and "lost"; ``slam._insert_step`` and
``slam._relocalize_step``) on the CPU, on ``test_torch_graph.py``'s 24-frame
320 x 180 sequence: inserts at 8 and 17, a blackout at 14-15 (lost, frame
15 fails to relocalize, 16 recovers; in keyframe mode the KLT loop recovers
at 17 and inserts at 18).

The capture itself needs the card (``tests/test_torch_cuda.py``); here the
frame program runs eagerly (``eager_replays``), which checks everything
around the capture: what each branch would capture makes no host read,
its write-back, the branches taken, and the results bitwise the eager
route's and close to the reference's.
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
INSERTS = (8, 17)
LOST = 15          # the first frame that runs the lost program (it fails)
RECOVERED = 16     # the frame that relocalizes (map mode; re-detect and features in keyframe mode)


def _slam(seq, mode="map", graphs=False, **cfg):
    """A CPU ``PTZSlam`` bootstrapped on frame 0 (with the graph route's
    ``Runner`` where ``graphs``), its state and frame 0's (xy, valid)."""
    imgs, cams, intr = seq
    slam = tslam.PTZSlam(port_cfg(_cfg(mode).replace(**cfg)), port_intr(intr), device="cpu")
    xy0, desc0, valid0 = tfront.extract_features(t(imgs[0]), slam.cfg)
    state = slam.init(xy0, desc0, valid0, cams[0])
    if graphs:
        slam._graphs = _graphs.Runner(CPU)
    return slam, state, xy0, valid0


@pytest.fixture(scope="module")
def feats(seq):
    """Every frame's re-detect features, stacked (T, K, ...)."""
    cfg = port_cfg(_cfg())
    out = [tfront.extract_features(t(im), cfg) for im in seq[0]]
    return tuple(torch.stack([f[i] for f in out]) for i in range(3))


class Loop:
    """One ``PTZSlam`` on the sequence through a tracking loop of ``kind``
    ("redetect": ``run_segment_pixels``; "klt": ``run_segment_pixels_klt``,
    the carry threaded from call to call; "features": ``run_segment``;
    "step": ``step`` a frame at a time)."""

    def __init__(self, seq, feats, kind, mode="map", graphs=False, masked=False, **cfg):
        self.slam, self.state, xy0, v0 = _slam(seq, mode, graphs, **cfg)
        self.kind, self.feats = kind, feats
        self.frames = t(seq[0])
        self.masks = torch.from_numpy(_masks()) if masked else None
        self.carry = (xy0, v0)

    def run(self, a: int, b: int):
        """Frames [a, b) in one call: their stacked infos."""
        slam, masks = self.slam, None if self.masks is None else self.masks[a:b]
        if self.kind == "redetect":
            self.state, infos = slam.run_segment_pixels(self.state, self.frames[a:b], masks)
        elif self.kind == "klt":
            self.state, infos, *self.carry = slam.run_segment_pixels_klt(
                self.state, self.frames[a:b], self.frames[a - 1], *self.carry, masks=masks
            )
        elif self.kind == "features":
            self.state, infos = slam.run_segment(self.state, *(f[a:b] for f in self.feats))
        else:
            out = []
            for k in range(a, b):
                self.state, info = slam.step(self.state, *(f[k] for f in self.feats))
                out.append(info)
            infos = tslam._stack(out)
        return infos

    def graph(self) -> _graphs.TrackGraph:
        (g,) = self.slam._graphs.graphs.values()
        return g


def _cat(parts) -> tslam.FrameInfo:
    return tslam.FrameInfo(*(torch.cat(f) for f in zip(*parts)))


def _named(tree, prefix=""):
    """(dotted field name, leaf) of nested NamedTuples, in field order."""
    if isinstance(tree, tuple):
        return [p for name, v in zip(tree._fields, tree) for p in _named(v, f"{prefix}{name}.")]
    return [(prefix[:-1], tree)]


# (a) what the insert and lost programs capture makes no host read --------------


def _graph_at(seq, feats, kind, mode, masked, stop):
    """A ``TrackGraph`` of ``kind`` loaded with the eager route's state (and
    KLT carry) after frames 1 to ``stop`` - 1."""
    loop = Loop(seq, feats, "features" if kind == "features" else kind, mode, masked=masked)
    loop.run(1, stop)
    slam = loop.slam
    if kind == "features":
        g = _graphs.TrackGraph(loop.state, tuple(feats[1].shape[1:]), cfg=slam.cfg, intr=slam.intr, device=CPU, kind=kind)
        g.load(loop.state)
    else:
        g = _graphs.TrackGraph(
            loop.state, (H, W), masked, cfg=slam.cfg, intr=slam.intr, device=CPU, kind=kind,
            carry_rows=loop.carry[0].shape[0],
        )
        g.load(loop.state, carry=(loop.frames[stop - 1], *loop.carry) if kind == "klt" else ())
    return g, loop


def _inputs(loop, kind, k):
    if kind == "features":
        return tuple(f[k] for f in loop.feats)
    return loop.frames[k], None if loop.masks is None else loop.masks[k]


@pytest.mark.parametrize("iters", [0, 8])
@pytest.mark.parametrize("rows", [1, 2, 8])
def test_ba_predicate_is_the_count_after_the_insert(rows, iters):
    """``slam._ba_follows``, read with the tracked flags before the insert,
    is ``_keyframe``'s read after it: ``online_ba_iters`` > 0 and the
    insert's count ``min(count + 1, max_keyframes)`` >= 2, at every count."""
    from types import SimpleNamespace

    for count in range(rows + 1):
        kf = SimpleNamespace(count=torch.tensor(count, dtype=torch.int32), poses=torch.zeros(rows, 3))
        got = tslam._ba_follows(SimpleNamespace(kf=kf), SimpleNamespace(online_ba_iters=iters))
        assert got.dtype == torch.bool and bool(got) == (iters > 0 and min(count + 1, rows) >= 2), count


@pytest.mark.parametrize("ba", [False, True], ids=["insert", "insert+ba"])
def test_insert_program_makes_no_host_read(seq, feats, ba):
    """What the "insert" / "insert+ba" program captures -- the insert, the
    windowed BA where its predicate holds, and the write-back -- runs under
    a dispatch mode that fails on any host read (after one warm-up run, as
    on the card, which makes the cached constants), and leaves the buffers
    bitwise as ``slam._insert_step`` leaves its state."""
    g, loop = _graph_at(seq, feats, "redetect", "map", False, INSERTS[0])
    xy, desc, valid = tfront.extract_features(loop.frames[INSERTS[0]], g.cfg, focal=tslam._safe_focal(loop.state, g.cfg))
    s2, _, flags = tslam._track_step(loop.state, xy, desc, valid, cfg=g.cfg, intr=g.intr)
    assert flags.tolist() == [False, True] and bool(tslam._ba_follows(s2, g.cfg))
    g.feats = [xy, desc, valid]
    g.load(s2)
    g._insert(ba)
    g.load(s2)
    with NoHostRead():
        g._insert(ba)
    want = tslam._insert_step(s2, xy, desc, valid, cfg=g.cfg, intr=g.intr, ba=ba)
    assert _same(g.state, want) and int(g.state.kf.count) == int(s2.kf.count) + 1


@pytest.mark.parametrize(
    "kind, mode, masked",
    [(k, m, False) for k in ("redetect", "klt", "features") for m in ("map", "keyframe")]
    + [("redetect", "map", True), ("klt", "keyframe", True)],
)
def test_lost_program_makes_no_host_read(seq, feats, kind, mode, masked):
    """What the "lost" program captures -- the frontend (re-detect, KLT on
    the carry, none), the match and solve, the re-seed and the stay-lost
    step selected on the device, and the write-back with the carry's tail
    -- runs under a dispatch mode that fails on any host read, after one
    warm-up run, and leaves the buffers and the carry bitwise as the eager
    route's relocalization frame."""
    g, loop = _graph_at(seq, feats, kind, mode, masked, RECOVERED)
    assert bool(loop.state.lost)
    start = _graphs._clone(g.state), [v.clone() for v in g.carry]

    def restart():
        g.load(start[0], then=zip(g.carry, start[1]))
        g._fill(_inputs(loop, kind, RECOVERED))

    restart()
    g._lost()
    restart()
    with NoHostRead():
        info, success = g._lost()
    loop.run(RECOVERED, RECOVERED + 1)
    assert _same(g.state, loop.state) and bool(success) == bool(info.reloc_success)
    if kind == "klt":
        assert torch.equal(g.carry[0], loop.frames[RECOVERED])
        assert all(torch.equal(a, b) for a, b in zip(g.carry[1:], loop.carry))


# (b) the graph loops are the eager route, bitwise, and take every branch ------


CALLS = ((1, 2), (2, 9), (9, 10), (10, 16), (16, 17), (17, FRAMES))


@pytest.mark.parametrize(
    "kind, mode, cfg",
    [(k, m, {}) for k in ("redetect", "klt", "features", "step") for m in ("map", "keyframe")]
    + [("redetect", "map", {"online_ba_iters": 0})],
    ids=lambda v: f"{v}" if not isinstance(v, dict) else ("no-ba" if v else "ba"),
)
def test_graph_loop_replays_insert_and_lost_programs_bitwise(seq, feats, eager_replays, kind, mode, cfg):
    """Over the whole sequence, in calls of one frame and of several, the
    graph loop gives bitwise the eager route's states, infos and KLT carry,
    and every frame ran from the frame program's replays, which took each
    branch where the eager route did: the insert with BA ("insert" where
    ``online_ba_iters`` = 0) on frames 8 and 17, the lost branch on the
    relocalization frames, the track branch on the others."""
    runs = {}
    for graphs in (True, False):
        loop = Loop(seq, feats, kind, mode, graphs, **cfg)
        runs[graphs] = _cat([loop.run(a, b) for a, b in CALLS]), loop
    (i_g, g_loop), (i_e, e_loop) = runs[True], runs[False]
    assert _same(i_g, i_e) and _same(g_loop.state, e_loop.state)
    assert all(torch.equal(a, b) for a, b in zip(g_loop.carry, e_loop.carry))
    g = g_loop.graph()
    insert = "insert+ba" if not cfg else "insert"
    event = n(i_e.event)
    assert n(i_e.keyframe).sum() == 2 and g.counts[insert] == 2
    assert g.counts[{"insert": "insert+ba", "insert+ba": "insert"}[insert]] == 0
    assert n(i_e.reloc_success).any() and g.counts["lost"] == int((event == 1).sum()) >= 2
    assert g.counts["track"] == int((event == 0).sum()) and g.program.replays == FRAMES - 1


# (c) the insert's tail writes back every field the branch changes -----------------


@pytest.mark.parametrize("ba", [False, True], ids=["insert", "insert+ba"])
def test_insert_tail_writes_back_every_changed_field(seq, feats, ba):
    """After the insert program, every state buffer holds
    ``slam._insert_step``'s value, and every field the branch changes was
    written by the tail: the whole keyframe store, the ray store's
    bookkeeping (and, with the BA, its rays), the EKF's ``ray_ids`` (and,
    with the BA, ``cam`` and ``cov``) and, with the BA, ``lost``; the
    fields it leaves are not written."""
    g, loop = _graph_at(seq, feats, "redetect", "map", False, INSERTS[1])
    xy, desc, valid = tfront.extract_features(loop.frames[INSERTS[1]], g.cfg, focal=tslam._safe_focal(loop.state, g.cfg))
    s2, _, flags = tslam._track_step(loop.state, xy, desc, valid, cfg=g.cfg, intr=g.intr)
    assert flags.tolist() == [False, True]
    g.load(s2)
    g.feats = [xy, desc, valid]
    before = {name: buf._version for name, buf in _named(g.state)}
    g._insert(ba)
    want_state = tslam._insert_step(s2, xy, desc, valid, cfg=g.cfg, intr=g.intr, ba=ba)
    want, given = dict(_named(want_state)), dict(_named(s2))
    written = {name for name, buf in _named(g.state) if buf._version != before[name]}
    changed = {name for name in want if want[name] is not given[name]}
    assert _same(g.state, want_state) and written == changed
    kf = {name for name in want if name.startswith("kf.")}
    must = kf | {"rays.valid", "rays.views", "rays.count", "rays.last_seen", "ekf.ray_ids"}
    if ba:
        must |= {"rays.rays", "ekf.cam", "ekf.cov", "lost"}
    assert must <= written and len(kf) == 8, sorted(must - written)


# (d) the graph route against the reference ----------------------------------------


@pytest.mark.parametrize("mode", ["map", "keyframe"])
def test_graph_insert_and_reloc_frames_hold_against_the_reference(seq, eager_replays, mode):
    """``step`` on the graph route (every frame kind from its program) and
    ``ptzjax``'s jitted ``_frame_step`` on the same features, from the same
    bootstrap, at ``test_torch_graph.py``'s tolerances: flags equal, matches
    within 2, poses within 5e-4 rad and 2 px, on every frame and on the
    insert frames 8 and 17 and the relocalization frame 16 by name."""
    imgs, cams, intr = seq
    cfg = _cfg(mode).replace(descriptor_f_ref=0.0)   # fixed descriptor spacing: features shared
    fts = [tuple(np.asarray(v) for v in j_extract(jnp.asarray(im), cfg, use_pallas=False)) for im in imgs]
    jslam = JaxSlam(cfg, intr)
    jstate = jslam.init(*fts[0], cams[0])
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    slam._graphs = _graphs.Runner(CPU)
    state = slam.init(*(t(v) for v in fts[0]), cams[0])
    ref, got = [None], [None]
    for k in range(1, FRAMES):
        jstate, jinfo = jslam._step(jstate, *(jnp.asarray(v) for v in fts[k]))
        state, info = slam.step(state, *(t(v) for v in fts[k]))
        ref.append(jax.device_get(jinfo))
        got.append(info)
    for key in ("lost", "event", "keyframe", "reloc_success"):
        assert [int(getattr(i, key)) for i in got[1:]] == [int(getattr(i, key)) for i in ref[1:]], key
    assert [k for k in range(1, FRAMES) if bool(got[k].keyframe)] == list(INSERTS)
    assert int(got[RECOVERED].event) == 1 and bool(got[RECOVERED].reloc_success)
    matches = [int(a.num_matches) - int(b.num_matches) for a, b in zip(got[1:], ref[1:])]
    assert max(map(abs, matches)) <= 2
    dpose = np.abs(np.stack([n(i.pose) for i in got[1:]]) - np.stack([np.asarray(i.pose) for i in ref[1:]]))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    (g,) = slam._graphs.graphs.values()
    assert g.counts["insert+ba"] == 2 and g.counts["lost"] >= 2


# (e) a rewound state replays the same through an insert and a lost frame ---------


@pytest.mark.parametrize("kind", ["redetect", "klt", "features"])
def test_rewound_state_replays_the_same_through_insert_and_lost_frames(seq, feats, eager_replays, kind):
    """The forest's rewind: a state (and carry) kept from frame 7, run again
    through frames 7-18 (both inserts, the blackout and the recovery) on
    the same graphs, whose frame program is captured by then, gives
    bitwise the first run's result."""
    loop = Loop(seq, feats, kind, "map", graphs=True)
    loop.run(1, 7)
    mid = loop.state, list(loop.carry)
    first = loop.run(7, 19), loop.state, list(loop.carry)
    loop.state, loop.carry = mid
    again = loop.run(7, 19), loop.state, list(loop.carry)
    assert _same(first[0], again[0]) and _same(first[1], again[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], again[2]))
    counts = loop.graph().counts
    assert counts["insert+ba"] >= 4 and counts["lost"] >= 4
