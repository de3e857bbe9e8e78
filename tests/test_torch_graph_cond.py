"""The frame program of the CUDA-graph loops (``ptzjax_torch/_graphs.py``:
``TrackGraph._frame``, whose conditions pick the lost, track and insert
branches on the device) and the homography baseline's graph loop
(``_graphs.VOGraph``) on the CPU, on ``test_torch_graph.py``'s 24-frame
320 x 180 sequence: inserts at 8 and 17, a blackout at 14-15 (lost, frame 15
fails to relocalize, 16 recovers).

The captures and the conditional nodes need the card
(``tests/test_torch_cuda.py``); here the frame program runs with its
conditions read on the host (``host_cond``) and every capture replaced by
eager replays (``eager_replays``), which checks everything around them: the
program reads nothing but its conditions, it is bitwise the eager route
over a whole segment in one call, a call reads the card once whatever its
frame kinds, and ``taken`` counts the branches and credits the launches.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ptzjax import baselines as jbase
from ptzjax.frontend import extract_features as j_extract
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import _graphs
from ptzjax_torch import baselines as tbase
from ptzjax_torch import slam as tslam
from ptzjax_torch.kernels import _build
from tests._torch_port import n, port_cfg, port_intr, t
from tests.test_baselines import CFG as BASE_CFG
from tests.test_baselines import make_features
from tests.test_torch_graph import FRAMES, NoHostRead, _cfg, _same, eager_replays, host_cond, seq  # noqa: F401
from tests.test_torch_graph_insert_reloc import INSERTS, LOST, RECOVERED, Loop, _graph_at, _inputs, feats  # noqa: F401

torch.set_num_threads(2)

SKIPPED = 5


def _taken(g) -> dict:
    return dict(zip(_graphs.BRANCHES, g.taken.tolist()))


def _kinds(infos) -> dict:
    """The branches the eager route's infos say were taken (every insert
    here is followed by the windowed BA)."""
    event, keyframe = n(infos.event), n(infos.keyframe)
    return {
        "lost": int((event == 1).sum()), "track": int((event == 0).sum()), "insert+ba": int(keyframe.sum()), "insert": 0,
    }


# the frame program's structure ------------------------------------------------


class Recorder:
    """``cond`` and ``branch`` that record the program they are called
    with, as ``_Assembly`` builds it."""

    def __init__(self):
        self.log = []

    def cond(self, pred, then, otherwise=None):
        self.log.append(("set", pred))
        for which, fn in (("if", then), ("if not", otherwise)):
            if fn is not None:
                self.log.append((which, "{"))
                fn()
                self.log.append((which, "}"))

    def branch(self, name):
        self.log.append(("branch", name))


def test_frame_program_nests_the_reference_conds(seq):
    """``TrackGraph._frame``: one read of the lost flag sets both outer
    conditions before either branch; IF(lost) the lost branch; IF(not lost)
    the track branch, then IF(insert and BA) and IF(insert and not BA) on
    the two insert predicates the track branch writes."""
    loop = Loop(seq, None, "redetect")
    g = _graphs.TrackGraph(loop.state, (180, 320), cfg=loop.slam.cfg, intr=loop.slam.intr, device=torch.device("cpu"))
    rec = Recorder()
    g._frame(rec.cond, rec.branch)
    log = [(a, b if isinstance(b, str) else b.data_ptr()) for a, b in rec.log]
    ins = g.inserts.data_ptr()
    assert log == [
        ("set", g.state.lost.data_ptr()),
        ("if", "{"), ("branch", "lost"), ("if", "}"),
        ("if not", "{"), ("branch", "track"),
        ("set", ins), ("if", "{"), ("branch", "insert+ba"), ("if", "}"),
        ("set", ins + 1), ("if", "{"), ("branch", "insert"), ("if", "}"),
        ("if not", "}"),
    ]


# (a) the frame program reads nothing but its conditions --------------------------


@pytest.mark.parametrize("frame", [3, INSERTS[0], RECOVERED], ids=["tracked", "insert", "lost"])
@pytest.mark.parametrize("kind", ["redetect", "klt", "features"])
def test_frame_program_makes_no_host_read_outside_its_conditions(seq, feats, kind, frame):
    """The whole frame program, after its warm-up (which makes the cached
    constants and puts the buffers back), under a dispatch mode that fails
    on any host read, with ``host_cond`` reading each condition outside the
    mode and running the branch it picks: it leaves the state, the KLT
    carry and the info buffer bitwise as the eager route's frame, and
    ``taken`` holds the branches the frame took."""
    g, loop = _graph_at(seq, feats, kind, "map", False, frame)
    g._fill(_inputs(loop, kind, frame))
    g.program.warm(g)
    with NoHostRead():
        g._frame(host_cond, g._branch)
    info = loop.run(frame, frame + 1)
    assert _same(g.state, loop.state) and _same(tslam._stack([g.info]), info)
    if kind == "klt":
        assert torch.equal(g.carry[0], loop.frames[frame])
        assert all(torch.equal(a, b) for a, b in zip(g.carry[1:], loop.carry))
    want = {3: [0, 1, 0, 0], INSERTS[0]: [0, 1, 1, 0], RECOVERED: [1, 0, 0, 0]}[frame]
    assert g.taken.tolist() == want


# (b) a whole segment in one call is the eager route, bitwise ------------------------


def _segment(seq, feats, kind, mode, masked, graphs, **cfg):
    """Frames 1-23 in one call (frame SKIPPED skipped): (infos, loop)."""
    loop = Loop(seq, feats, kind, mode, graphs, masked, **cfg)
    ok = np.ones(FRAMES - 1, bool)
    ok[SKIPPED - 1] = False
    slam, masks = loop.slam, None if loop.masks is None else loop.masks[1:]
    if kind == "redetect":
        loop.state, infos = slam.run_segment_pixels(loop.state, loop.frames[1:], masks, frame_ok=ok)
    elif kind == "klt":
        loop.state, infos, *loop.carry = slam.run_segment_pixels_klt(
            loop.state, loop.frames[1:], loop.frames[0], *loop.carry, frame_ok=ok, masks=masks
        )
    else:
        loop.state, infos = slam.run_segment(loop.state, *(f[1:] for f in feats), frame_ok=ok)
    return infos, loop


@pytest.mark.parametrize(
    "kind, mode, masked",
    [(k, m, False) for k in ("redetect", "klt", "features") for m in ("map", "keyframe")]
    + [("redetect", "map", True), ("klt", "keyframe", True)],
)
def test_one_call_segment_is_the_eager_route_bitwise(seq, feats, eager_replays, kind, mode, masked):
    """Frames 1-23 in one call (both inserts, the blackout, the recovery and
    a skipped frame): the graph loop's infos, final state and KLT carry are
    bitwise the eager route's, and its branch counts are the frame kinds."""
    i_g, g_loop = _segment(seq, feats, kind, mode, masked, True)
    i_e, e_loop = _segment(seq, feats, kind, mode, masked, False)
    assert _same(i_g, i_e) and _same(g_loop.state, e_loop.state)
    assert all(torch.equal(a, b) for a, b in zip(g_loop.carry, e_loop.carry))
    g = g_loop.graph()
    assert g.counts == _kinds(i_e) and g.counts["insert+ba"] >= 2 and g.counts["lost"] >= 2
    assert n(i_e.event).tolist().count(2) == 1 and g.program.replays == FRAMES - 2


@pytest.mark.parametrize("kind", ["redetect", "features"])
def test_one_call_segment_holds_against_the_reference(seq, eager_replays, kind):
    """Frames 1-23 in one call on the graph loop and through ``ptzjax``'s
    ``run_segment_pixels`` (re-detect) or ``run_segment`` (features, on the
    reference's features), from the same bootstrap, at the graph tests'
    tolerances: flags equal, matches within 2, poses within 5e-4 rad and 2
    px, the inserts and the recovery where the eager route has them."""
    imgs, cams, intr = seq
    cfg = _cfg("map")
    if kind == "features":
        cfg = cfg.replace(descriptor_f_ref=0.0)   # fixed descriptor spacing: features shared
    fts = [j_extract(jnp.asarray(im), cfg, use_pallas=False) for im in imgs]
    jslam = JaxSlam(cfg, intr)
    jstate = jslam.init(*fts[0], cams[0])
    slam = tslam.PTZSlam(port_cfg(cfg), port_intr(intr), device="cpu")
    slam._graphs = _graphs.Runner(torch.device("cpu"))
    state = slam.init(*(t(np.asarray(v)) for v in fts[0]), cams[0])
    if kind == "redetect":
        _, ref = jslam.run_segment_pixels(jstate, jnp.asarray(imgs[1:]), use_pallas=False)
        _, got = slam.run_segment_pixels(state, t(imgs[1:]))
    else:
        stacked = [np.stack([np.asarray(f[i]) for f in fts[1:]]) for i in range(3)]
        _, ref = jslam.run_segment(jstate, *(jnp.asarray(v) for v in stacked))
        _, got = slam.run_segment(state, *(t(v) for v in stacked))
    ref = jax.device_get(ref)
    for key in ("lost", "event", "keyframe", "reloc_success"):
        np.testing.assert_array_equal(n(getattr(got, key)), np.asarray(getattr(ref, key)), err_msg=key)
    assert np.abs(n(got.num_matches).astype(int) - np.asarray(ref.num_matches).astype(int)).max() <= 2
    dpose = np.abs(n(got.pose) - np.asarray(ref.pose))
    assert dpose[:, :2].max() < 5e-4 and dpose[:, 2].max() < 2.0, dpose.max(0)
    assert [k + 1 for k in np.nonzero(n(got.keyframe))[0]] == list(INSERTS)
    assert n(got.reloc_success).any()


# (c) a call reads the card once, whatever its frame kinds ------------------------------


class Reads(TorchDispatchMode):
    """Counts the host's reads of tensor values: ``bool()``, ``int()`` and
    ``float()`` of a tensor (``aten._local_scalar_dense``) and
    ``Tensor.tolist`` (counted by the test's patched ``tolist``)."""

    count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Reads.count += str(func).startswith("aten._local_scalar_dense")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["redetect", "klt", "features"])
def test_a_segment_call_reads_the_card_once(seq, feats, eager_replays, monkeypatch, kind):
    """On the graph loop (its conditions read outside the count, as the
    card reads them), every call makes exactly one host read: one-frame
    calls of each frame kind (tracked, insert, lost, recovery), and calls of
    several frames that hold an insert, the blackout and the recovery."""
    tolist = torch.Tensor.tolist

    def counting_tolist(self):
        Reads.count += 1
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting_tolist)
    runs = {}
    for name, calls in (
        ("one frame", [(k, k + 1) for k in range(1, RECOVERED + 2)]),
        ("several", [(1, 2), (2, 12), (12, 20), (20, FRAMES)]),
    ):
        loop = Loop(seq, feats, kind, "map", graphs=True)
        runs[name] = []
        for a, b in calls:
            Reads.count = 0
            with Reads():
                info = loop.run(a, b)
            runs[name].append((Reads.count, {int(e) + 2 * int(k) for e, k in zip(n(info.event), n(info.keyframe))}))
    assert [r for r, _ in runs["one frame"] + runs["several"]] == [1] * (RECOVERED + 5)
    kinds = [k for _, k in runs["one frame"]]
    assert kinds[INSERTS[0] - 1] == {2} and kinds[LOST - 1] == {1} == kinds[RECOVERED - 1] and kinds[2] == {0}
    assert [k for _, k in runs["several"]][1:3] == [{0, 2}, {0, 1, 2}]


# (d) taken counts the branches, and the launches are credited from it -------------------


@pytest.mark.parametrize("cfg", [{}, {"online_ba_iters": 0}], ids=["ba", "no-ba"])
def test_taken_counts_the_branches_and_credits_the_launches(seq, feats, eager_replays, monkeypatch, cfg):
    """After each call ``taken`` holds the frames that took each branch
    (the lost, track and insert branches of the eager route's infos, the
    insert without BA where ``online_ba_iters`` = 0), and the counters rose
    by each branch's captured rise times its count."""
    for mod, name in _graphs.COUNTERS:
        monkeypatch.setattr(mod, name, 0)
    rise = {"lost": (1, 0, 0, 1, 0, 0, 0, 0), "track": (1, 1, 0, 1, 1, 0, 1, 1),
            "insert+ba": (0, 0, 0, 1, 0, 0, 0, 0), "insert": (0, 0, 3, 0, 0, 0, 0, 0)}
    loop = Loop(seq, feats, "redetect", "map", graphs=True, **cfg)
    loop.run(1, 2)
    g = loop.graph()
    g.program.rise = rise
    for mod, name in _graphs.COUNTERS:
        setattr(mod, name, 0)
    total = dict.fromkeys(_graphs.BRANCHES, 0)
    for a, b in ((2, 9), (9, 16), (16, FRAMES)):
        infos = loop.run(a, b)
        want = _kinds(infos)
        if cfg:
            want["insert"], want["insert+ba"] = want["insert+ba"], 0
        assert _taken(g) == want
        total = {k: total[k] + want[k] for k in total}
    assert total["lost"] >= 2 and total["insert+ba" if not cfg else "insert"] == 2
    got = [getattr(mod, name) for mod, name in _graphs.COUNTERS]
    assert got == [sum(rise[b][i] * total[b] for b in _graphs.BRANCHES) for i in range(len(got))]


# a failed capture names its branch and keeps the first error -------------------------


@pytest.mark.parametrize("failure", ["raises", "invalidates"])
def test_failed_capture_names_its_branch_and_keeps_the_first_error(monkeypatch, failure):
    """Pure Python, with the capture machinery stood in for: where the
    branch raises, or returns from a capture an error invalidated, and the
    end of the capture then reports an error of its own, ``_capture``
    raises naming the branch, with the first error as its cause, and puts
    the counters back."""
    for mod, name in _graphs.COUNTERS:
        monkeypatch.setattr(mod, name, 0)

    class Graph:
        def __init__(self, keep_graph=False):
            pass

    class Capture:
        def __init__(self, graph, **kw):
            pass

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            raise RuntimeError("operation failed due to a previous error during capture")

    def status(stream, out):
        out._obj.value = 2   # cudaStreamCaptureStatusInvalidated
        return 0

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(ptz_capture_status=status))
    first = ValueError("a host read")

    def body():
        _graphs.harris_nms.launches += 1
        if failure == "raises":
            raise first

    with pytest.raises(RuntimeError, match="the frame graph's 'insert' branch failed") as caught:
        _graphs._capture(body, types.SimpleNamespace(cuda_stream=0), "the frame graph's 'insert' branch")
    cause = caught.value.__cause__
    if failure == "raises":
        assert cause is first
    else:
        assert "invalidated (cudaStreamCaptureStatus 2)" in str(cause)
    assert all(getattr(mod, name) == 0 for mod, name in _graphs.COUNTERS)


# the homography baseline's graph loop ---------------------------------------------


def test_baseline_graph_loop_is_the_eager_loop_and_holds_against_the_reference(eager_replays):
    """``_graphs.VOGraph`` (``baselines._frame`` from one program over
    static buffers; its first frame eager, the rest replays) over
    test_baselines.py's 40 frames: bitwise the eager loop (infos and final
    carry), the caller's state untouched, one replay a frame after the
    first; and, as the eager loop, the reference's accepted flags and
    inlier counts, poses within 5e-4 rad and 2 px."""
    seq_b, xy, desc, valid = make_features(T=40)
    cfg, intr = port_cfg(BASE_CFG), port_intr(seq_b.intr)
    state = tbase.init_vo(seq_b.cameras[0], xy[0], desc[0], valid[0], cfg, device="cpu")
    kept = _graphs._clone(state)
    frames = [t(np.asarray(v[1:])) for v in (xy, desc, valid)]
    g = _graphs.VOGraph(state, cfg=cfg, intr=intr)
    s_g, i_g = g.run(state, *frames)
    s_e, i_e = tbase.track_homography_ekf(state, *frames, intr=intr, cfg=cfg)
    assert _same(i_g, i_e) and _same(s_g, s_e) and _same(state, kept)
    assert g.program.replays == 38
    j_state = jbase.init_vo(seq_b.cameras[0], xy[0], desc[0], valid[0], BASE_CFG)
    _, want = jbase.track_homography_ekf(j_state, xy[1:], desc[1:], valid[1:], intr=seq_b.intr, cfg=BASE_CFG)
    assert np.array_equal(n(i_g.updated), np.asarray(want.updated))
    assert np.array_equal(n(i_g.num_inliers), np.asarray(want.num_inliers))
    d = np.abs(n(i_g.pose) - np.asarray(want.pose))
    assert d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, d.max(0)
