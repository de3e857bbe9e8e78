"""The tracking loops on the card as CUDA graphs: each tracked frame of the
re-detect loop (``run_segment_pixels``), the KLT loop
(``run_segment_pixels_klt``) and the features loop (``run_segment`` and
``step``) is the replay of one graph that holds the whole frame -- the
frontend (re-detect: kernels A and F, the top-k; KLT: the pyramids, kernel
E, the refill detection with A and the descriptors with F; features: none),
the track step (kernels C and D, the EKF) and the keyframe predicates --
and one host read of its (lost, insert) flags.

This is how the port carries over the reference's single device program a
frame (``ptzjax/slam.py``: ``jax.jit`` of a ``lax.scan`` over
``_frame_step``, whose ``lax.cond``s pick track or relocalize and insert or
not). A graph cannot branch, so the frame splits where the reference's
conds are: the tracked step up to its insert predicate
(``slam._track_step``) is captured; an insert (``slam._keyframe``: the
insert and the windowed BA) and a lost frame (``slam._relocalize``) run
eagerly after it, as the eager route runs them. Both are rare: 2 inserts
in the 192 frames of the bench sequence.

A ``TrackGraph`` owns static buffers: the frame's inputs (the image and the
mask where the frames have one, or the features), the carry of KLT mode
(the previous image and keypoint table) and the whole ``SlamState``. A call
copies the caller's state (and carry) in; each tracked frame copies its
inputs in and replays. The graph's tail copies the fields the step changed
back into the state buffers, which the next replay reads, and in KLT mode
the frame's image and table into the carry; the keyframe store, which
tracking only reads, is not copied. Eager frames read the buffers and copy
their results in. The call returns fresh tensors: the caller's state and
carry are never written, so an earlier state replayed later (the forest's
rewind) gives the same result.

The first tracked frame of a graph runs eagerly on the graph's own stream:
a real frame of the loop, its launches counted. It creates, from the
ordinary allocator and before the capture, what the frame's kernels keep
between calls: the cuBLAS and cuSOLVER handles, the kernels' shared-memory
attributes and D's cluster query, F's spatial table and the wrappers'
workspaces, which are keyed by (device, stream). The capture launches
nothing, so the launch counters' rise during it is undone and added again
at every replay (``captured_rise``, ``credit``).

No fallback: a capture, instantiation or replay error raises.
"""

from __future__ import annotations

import time

import torch

from ptzjax_torch import slam
from ptzjax_torch.checkpoint import tree_flatten
from ptzjax_torch.frontend import extract_features, track_features
from ptzjax_torch.kernels import cholesky, descriptor, flow, harris_nms, match, window_gather

# every launch counter of the kernel wrappers, as (module, attribute)
COUNTERS = (
    (harris_nms, "launches"), (harris_nms, "masked_launches"), (window_gather, "launches"),
    (match, "launches"), (cholesky, "launches"), (flow, "launches"), (descriptor, "launches"),
)

# the frontends a graph may hold
KINDS = ("redetect", "klt", "features")


def _counts() -> tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def captured_rise(capture) -> tuple[int, ...]:
    """Run ``capture`` (a CUDA-graph capture, during which the wrappers
    count launches that do not happen), put the counters back and return
    their rise: what one replay launches."""
    before = _counts()
    try:
        capture()
        return tuple(a - b for a, b in zip(_counts(), before))
    finally:
        for (mod, name), value in zip(COUNTERS, before):
            setattr(mod, name, value)


def credit(rise: tuple[int, ...]) -> None:
    """Add one replay's launches to the counters."""
    for (mod, name), n in zip(COUNTERS, rise):
        setattr(mod, name, getattr(mod, name) + n)


def _rebuild(like, leaves):
    """``like``'s structure (nested NamedTuples) filled from the iterator
    ``leaves``."""
    if isinstance(like, tuple):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    return next(leaves)


def _copy(pairs) -> None:
    """``dst.copy_(src)`` for each (dst, src), one ``torch._foreach_copy_``
    (one launch on the card) for each dtype."""
    groups: dict = {}
    for dst, src in pairs:
        pair = groups.setdefault(dst.dtype, ([], []))
        pair[0].append(dst)
        pair[1].append(src)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _fresh(tensors: list) -> list:
    """``tensors`` as fresh tensors (one ``_foreach_copy_`` a dtype)."""
    out = [torch.empty_like(v) for v in tensors]
    _copy(zip(out, tensors))
    return out


def _clone(tree):
    """``tree`` (nested NamedTuples of tensors) as fresh tensors."""
    return _rebuild(tree, iter(_fresh(tree_flatten(tree)[0])))


def _check_fit(dst: torch.Tensor, src: torch.Tensor, what: str, dtype: bool = True) -> None:
    if src.shape != dst.shape or (dtype and src.dtype != dst.dtype):
        raise ValueError(
            f"{what} {src.dtype} {tuple(src.shape)} does not fit the graph's "
            f"{dst.dtype} {tuple(dst.shape)} (another config or shape?)"
        )


class TrackGraph:
    """One tracked frame as a CUDA graph over static buffers, for one
    frontend (``kind``), input shape, mask presence and config.

    ``kind`` "redetect" and "klt" take frames: ``shape`` is the image's (H,
    W), and ``masked`` says whether the frames have masks; "klt" also keeps
    the carry (the previous image, the (K, 2) table and its (K,) validity),
    with K from ``carry_rows``. "features" takes a frame's (K, 2) xy, (K, D)
    desc and (K,) valid: ``shape`` is (K, D). Images and features are copied
    into float32 buffers (bool for masks and validity)."""

    def __init__(
        self, like: slam.SlamState, shape, masked: bool = False, *, cfg, intr, device,
        kind: str = "redetect", carry_rows: int | None = None,
    ):
        if kind not in KINDS:
            raise ValueError(f"TrackGraph: kind {kind!r} is not one of {KINDS}")
        self.kind, self.cfg, self.intr, self.device = kind, cfg, intr, device
        self._bufs = [torch.empty_like(v, device=device) for v in tree_flatten(like)[0]]
        self.state = _rebuild(like, iter(self._bufs))

        def buf(size, dtype=torch.float32):
            return torch.empty(tuple(size), dtype=dtype, device=device)

        self.img = self.mask = None
        if kind == "features":
            k, d = shape
            self.inputs = (buf((k, 2)), buf((k, d)), buf((k,), torch.bool))
        else:
            self.img = buf(shape)
            self.mask = buf(shape, torch.bool) if masked else None
            self.inputs = (self.img, self.mask)
        # KLT's carry: the previous image, keypoint table and its validity
        self.carry = ()
        if kind == "klt":
            self.carry = (buf(shape), buf((carry_rows, 2)), buf((carry_rows,), torch.bool))
        self._replay = None     # the graph's replay, once captured
        self._out = None        # the graph's outputs: (info, flags, (xy, desc, valid))
        self._rise: tuple[int, ...] = ()
        self._keep = ()         # the workspaces the graph's kernels use
        self.capture_s = None   # capture + instantiation, seconds

    def load(self, state: slam.SlamState, carry=(), then=()) -> None:
        """Copy ``state`` (and in KLT mode the carry: previous image, xy,
        valid) into the buffers, and the (buffer, value) pairs ``then``
        after them; a source that is its buffer already is skipped. A state
        field, xy or valid of another shape or dtype raises, as does an
        image of another shape (an image's dtype is converted, as every
        frame's is)."""
        pairs = list(zip(self._bufs, tree_flatten(state)[0]))
        for dst, src in pairs:
            _check_fit(dst, src, "state field")
        if carry:
            carry = [torch.as_tensor(v, device=self.device) for v in carry]
            for k, (dst, src) in enumerate(zip(self.carry, carry)):
                _check_fit(dst, src, "KLT carry", dtype=k > 0)
            pairs += zip(self.carry, carry)
        _copy((d, s) for d, s in [*pairs, *then] if s is not d)

    def snapshot(self) -> tuple[slam.SlamState, list]:
        """The state buffers and the KLT table (xy, valid) as fresh tensors:
        (state, [xy, valid]) ([] for the other kinds)."""
        leaves = _fresh(self._bufs + list(self.carry[1:]))
        n = len(self._bufs)
        return _rebuild(self.state, iter(leaves[:n])), leaves[n:]

    def _frontend(self, inputs):
        """The frame's (xy, desc, valid) from its inputs (the input buffers
        in the graph, the frame's own tensors on a lost frame), and the
        (carry buffer, value) pairs that carry the frame on."""
        if self.kind == "features":
            return tuple(inputs), ()
        img, mask = inputs
        focal = slam._safe_focal(self.state, self.cfg)
        if self.kind == "redetect":
            return extract_features(img, self.cfg, mask=mask, focal=focal), ()
        pimg, pxy, pvalid = self.carry
        xy, desc, valid, _ = track_features(pimg, img, pxy, pvalid, self.cfg, mask=mask, focal=focal)
        return (xy, desc, valid), tuple(zip(self.carry, (img, xy, valid)))

    def _step(self):
        """What the graph holds: the frontend on the input buffers, the
        track step and keyframe predicates on the state buffers, then the
        tail that copies the changed fields back (and in KLT mode the
        frame's image and table into the carry)."""
        feats, tail = self._frontend(self.inputs)
        s2, info, flags = slam._track_step(self.state, *feats, cfg=self.cfg, intr=self.intr)
        _copy([*((d, s) for d, s in zip(self._bufs, tree_flatten(s2)[0]) if s is not d), *tail])
        return info, flags, feats

    def track(self, *inputs):
        """One tracked frame from its inputs (image and mask, or xy, desc
        and valid): (info, flags, (xy, desc, valid)), valid until the next
        call; the state (and carry) buffers hold the tracked frame's."""
        for dst, src in zip(self.inputs, inputs):
            if dst is not None:
                dst.copy_(torch.as_tensor(src))
        if self._replay is None:
            return self._first_frame()
        self._replay()
        credit(self._rise)
        return self._out

    def lost_frame(self, *inputs):
        """One frame while lost, eagerly on the buffers, as the eager route
        runs it (``slam._frame_step(..., lost=True)``): the frontend, the
        relocalization, then the state and the carry loaded. Returns (info,
        the new lost flag as a host bool)."""
        inputs = [None if v is None else torch.as_tensor(v, device=self.device) for v in inputs]
        feats, tail = self._frontend(inputs)
        s, info, lost = slam._frame_step(self.state, *feats, cfg=self.cfg, intr=self.intr, lost=True)
        info = _clone(info)
        self.load(s, then=tail)
        return info, lost

    def _first_frame(self):
        """The graph's first frame, eagerly on its own stream, then the
        capture."""
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = self._step()
        cur.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=stream):
                self._out = self._step()

        t0 = time.perf_counter()
        self._rise = captured_rise(capture)
        self.capture_s = time.perf_counter() - t0
        # a later warm-up on a stream of the same key may replace a
        # workspace; the graph keeps the ones it was captured with
        self._keep = (dict(harris_nms._workspace), dict(match._workspace))
        self._replay = graph.replay
        return out


class Runner:
    """The graph route of ``PTZSlam``'s tracking loops on the card
    (``run_segment_pixels``, ``run_segment_pixels_klt``, ``run_segment``
    and ``step``): one ``TrackGraph`` per (kind, mask presence, image shape
    or K and D, config), kept for the life of the ``PTZSlam``. Each loop is
    its eager counterpart in ``slam.py`` with each tracked frame replayed
    from its graph: bitwise the same results."""

    def __init__(self, device):
        self.device = device
        self.graphs: dict = {}

    def _graph(self, kind, masked, shape, state, *, cfg, intr, carry_rows=None) -> TrackGraph:
        key = (kind, masked, tuple(shape), cfg)
        if key not in self.graphs:
            self.graphs[key] = TrackGraph(
                state, shape, masked, cfg=cfg, intr=intr, device=self.device, kind=kind,
                carry_rows=carry_rows,
            )
        return self.graphs[key]

    def _loop(self, g: TrackGraph, frames, ok, lost: bool):
        """The frames (each a tuple of inputs) through ``g``: a skipped frame
        passes the state and carry through, a lost one runs eagerly, a
        tracked one is a replay and one read of its flags, then the insert
        eagerly where the flags ask for it. Returns (infos, the last
        frame's lost flag)."""
        infos = []
        for inputs, ok_i in zip(frames, ok):
            if not ok_i:
                infos.append(_clone(slam._skip_info(g.state)))
            elif lost:
                info, lost = g.lost_frame(*inputs)
                infos.append(info)
            else:
                info, flags, feats = g.track(*inputs)
                infos.append(_clone(info))
                lost, insert = flags.tolist()
                if insert:
                    s, lost = slam._keyframe(g.state, *feats, cfg=g.cfg, intr=g.intr)
                    g.load(s)
        return infos, lost

    def run_segment_pixels(self, state: slam.SlamState, imgs, masks, frame_ok, *, cfg, intr, lost: bool):
        """``slam._run_segment_pixels``: returns (fresh state, stacked
        infos, the final state's lost flag)."""
        t = imgs.shape[0]
        g = self._graph("redetect", masks is not None, imgs.shape[1:], state, cfg=cfg, intr=intr)
        g.load(state)
        frames = ((imgs[i], None if masks is None else masks[i]) for i in range(t))
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, t), lost)
        return g.snapshot()[0], slam._stack(infos), lost

    def run_segment_pixels_klt(
        self, state: slam.SlamState, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks, *, cfg, intr,
        lost: bool,
    ):
        """``slam._run_segment_pixels_klt``: returns (fresh state, stacked
        infos, fresh last xy, fresh last valid, the final state's lost
        flag)."""
        t = imgs.shape[0]
        g = self._graph(
            "klt", masks is not None, imgs.shape[1:], state, cfg=cfg, intr=intr,
            carry_rows=prev_xy.shape[0],
        )
        g.load(state, carry=(prev_img, prev_xy, prev_valid))
        frames = ((imgs[i], None if masks is None else masks[i]) for i in range(t))
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, t), lost)
        state, (xy, valid) = g.snapshot()
        return state, slam._stack(infos), xy, valid, lost

    def run_segment(self, state: slam.SlamState, xy_seq, desc_seq, valid_seq, frame_ok, *, cfg, intr, lost: bool):
        """``slam._run_segment`` (features on the card): returns (fresh
        state, stacked infos, the final state's lost flag)."""
        t = xy_seq.shape[0]
        g = self._graph("features", False, (xy_seq.shape[1], desc_seq.shape[2]), state, cfg=cfg, intr=intr)
        g.load(state)
        frames = ((xy_seq[i], desc_seq[i], valid_seq[i]) for i in range(t))
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, t), lost)
        return g.snapshot()[0], slam._stack(infos), lost

    def step(self, state: slam.SlamState, xy, desc, valid, *, cfg, intr, lost: bool):
        """``slam._frame_step`` on one frame of features: returns (fresh
        state, its FrameInfo, the new state's lost flag)."""
        g = self._graph("features", False, (xy.shape[0], desc.shape[1]), state, cfg=cfg, intr=intr)
        g.load(state)
        infos, lost = self._loop(g, [(xy, desc, valid)], [True], lost)
        return g.snapshot()[0], infos[0], lost
