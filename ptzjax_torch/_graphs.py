"""The tracking loops on the card as CUDA graphs: every frame of the
re-detect loop (``run_segment_pixels``), the KLT loop
(``run_segment_pixels_klt``) and the features loop (``run_segment`` and
``step``) is the replay of graphs over static buffers, a device program for
each frame kind, each followed by one host read of its flags.

This is how the port carries over the reference's single device program a
frame (``ptzjax/slam.py``: ``jax.jit`` of a ``lax.scan`` over
``_frame_step``, whose ``lax.cond``s pick track or relocalize, insert or
not, and windowed BA or not). A graph cannot branch, so the frame splits
where the reference's conds are, into the programs of a ``TrackGraph``:

- "track": the frontend (re-detect: kernels A and F, the top-k; KLT: the
  pyramids, kernel E, the refill detection with A and the descriptors with
  F; features: none), the track step (``slam._track_step``: kernels C and
  D, the EKF) and its keyframe predicates, then one read of its (lost,
  insert, BA) flags. The BA flag (``slam._ba_follows``) is known before the
  insert, so an insert frame reads it with the others.
- "insert" and "insert+ba": the insert branch (``slam._insert_step``: C,
  the keyframe and ray stores, and the windowed BA for "insert+ba"), on the
  frame's features copied into buffers of its own; after the BA, one read
  of the lost flag (its drift watchdog). An insert frame waits twice.
- "lost": the frontend and the lost branch (``slam._relocalize_step``: C
  and the pose solve, then the re-seed and the stay-lost step selected on
  the device), then one read of the success flag.

A ``TrackGraph`` owns static buffers: the frame's inputs (the image and the
mask where the frames have one, or the features), the carry of KLT mode
(the previous image and keypoint table), the whole ``SlamState`` and the
insert's features. A call copies the caller's state (and carry) in; each
frame copies its inputs in and replays. A program's tail copies the fields
its branch changed back into the state buffers, which the next program
reads, and in KLT mode the frame's image and table into the carry (the
tracked and the lost frame both move it on); the keyframe store, which
tracking only reads, is copied back by the insert only. The call returns
fresh tensors: the caller's state and carry are never written, so an
earlier state replayed later (the forest's rewind) gives the same result.

A program's first use runs eagerly on a stream of its own: a real frame of
the loop, its launches counted. It creates, from the ordinary allocator and
before the capture, what the frame's kernels keep between calls: the cuBLAS
and cuSOLVER handles, the kernels' shared-memory attributes and D's cluster
query, F's spatial table, ``_device.const``'s constants and the wrappers'
workspaces, which are keyed by (device, stream). The capture launches
nothing, so the launch counters' rise during it is undone and added again
at every replay (``captured_rise``, ``credit``).

No fallback: a capture, instantiation or replay error raises.
"""

from __future__ import annotations

import functools
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


class Program:
    """One device program of a ``TrackGraph``: ``fn(owner)`` (it reads the
    owner's buffers and writes its results back into them) runs eagerly on
    a stream of its own at its first use, which is then captured as a CUDA
    graph; every later use replays the graph and credits its launches.
    Returns what ``fn`` returns (from a replay: the graph's outputs, valid
    until the next replay). A program holds no reference to its owner, so
    a ``TrackGraph`` and its graphs' pools are freed when the last
    reference to it goes, not at some later garbage collection."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, device
        self.replay = None      # the graph's replay, once captured
        self.capture_s = None   # capture + instantiation, seconds
        self.pool_bytes = None  # memory_reserved's growth over the capture
        self._out = None        # the graph's outputs
        self._rise: tuple[int, ...] = ()
        self._keep = ()         # the workspaces the graph's kernels use

    def __call__(self, owner):
        if self.replay is None:
            return self.first_use(owner)
        self.replay()
        credit(self._rise)
        return self._out

    def first_use(self, owner):
        """``fn`` eagerly on the program's own stream, then the capture."""
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = self.fn(owner)
        cur.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=stream):
                self._out = self.fn(owner)

        # the capture empties the allocator's cache first: so does the
        # reading before it, so that the growth is the graph's pool
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self._rise = captured_rise(capture)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # a later warm-up on a stream of the same key may replace a
        # workspace; the graph keeps the ones it was captured with
        self._keep = (dict(harris_nms._workspace), dict(match._workspace))
        self.replay = graph.replay
        return out


class TrackGraph:
    """A frame's device programs (``Program``: "track", "insert",
    "insert+ba", "lost") over static buffers, for one frontend (``kind``),
    input shape, mask presence and config.

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
        self.feats = None   # the insert's (xy, desc, valid), made at the first insert
        self.programs = {
            "track": Program(TrackGraph._tracked, device),
            "insert": Program(functools.partial(TrackGraph._insert, ba=False), device),
            "insert+ba": Program(functools.partial(TrackGraph._insert, ba=True), device),
            "lost": Program(TrackGraph._lost, device),
        }

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

    def _frontend(self):
        """The frame's (xy, desc, valid) from the input buffers, and the
        (carry buffer, value) pairs that carry the frame on."""
        if self.kind == "features":
            return self.inputs, ()
        img, mask = self.inputs
        focal = slam._safe_focal(self.state, self.cfg)
        if self.kind == "redetect":
            return extract_features(img, self.cfg, mask=mask, focal=focal), ()
        pimg, pxy, pvalid = self.carry
        xy, desc, valid, _ = track_features(pimg, img, pxy, pvalid, self.cfg, mask=mask, focal=focal)
        return (xy, desc, valid), tuple(zip(self.carry, (img, xy, valid)))

    def _write_back(self, state: slam.SlamState, tail=()) -> None:
        """The tail of a program: the fields of ``state`` that are not their
        buffers already (those its branch changed) and the pairs ``tail``
        copied into their buffers."""
        _copy([*((d, s) for d, s in zip(self._bufs, tree_flatten(state)[0]) if s is not d), *tail])

    def _step(self):
        """The tracked frame: the frontend on the input buffers, the track
        step and keyframe predicates on the state buffers, then the tail
        that copies the changed fields back (and in KLT mode the frame's
        image and table into the carry). Returns (info, (lost, insert)
        flags, (xy, desc, valid))."""
        feats, tail = self._frontend()
        s2, info, flags = slam._track_step(self.state, *feats, cfg=self.cfg, intr=self.intr)
        self._write_back(s2, tail)
        return info, flags, feats

    def _tracked(self):
        """The "track" program: ``_step`` with the BA predicate of an insert
        stacked onto its flags: (info, (lost, insert, BA) flags, feats)."""
        info, flags, feats = self._step()
        return info, torch.cat([flags, slam._ba_follows(self.state, self.cfg).view(1)]), feats

    def _insert(self, ba: bool) -> None:
        """The "insert" / "insert+ba" program: the insert branch on the
        insert's feature buffers and the state buffers, then the tail, which
        copies back what it changed: the keyframe and ray stores, the EKF's
        ``cam``, ``cov`` and ``ray_ids``, and ``lost``."""
        s = slam._insert_step(self.state, *self.feats, cfg=self.cfg, intr=self.intr, ba=ba)
        self._write_back(s)

    def _lost(self):
        """The "lost" program: the frontend on the input buffers, the lost
        branch on the state buffers (both of its outcomes selected on the
        device), then the tail (and in KLT mode the carry's). Returns (info,
        success flag)."""
        feats, tail = self._frontend()
        s, info, success = slam._relocalize_step(self.state, *feats, cfg=self.cfg, intr=self.intr)
        self._write_back(s, tail)
        return info, success

    def _fill(self, inputs) -> None:
        for dst, src in zip(self.inputs, inputs):
            if dst is not None:
                dst.copy_(torch.as_tensor(src))

    def track(self, *inputs):
        """One tracked frame from its inputs (image and mask, or xy, desc
        and valid): (info, (lost, insert, BA) flags, (xy, desc, valid)),
        valid until the next call; the state (and carry) buffers hold the
        tracked frame's."""
        self._fill(inputs)
        return self.programs["track"](self)

    def insert(self, feats, ba: bool) -> bool:
        """The insert branch on the tracked frame's features ``feats``
        (copied into the insert's buffers, one ``_foreach_copy_`` a dtype),
        with the windowed BA where ``ba``. Returns the state's lost flag as
        a host bool: read after the BA (its drift watchdog may set it),
        False without one."""
        if self.feats is None:
            self.feats = [torch.empty_like(v) for v in feats]
        _copy(zip(self.feats, feats))
        self.programs["insert+ba" if ba else "insert"](self)
        return bool(self.state.lost) if ba else False

    def lost_frame(self, *inputs):
        """One frame while lost, from its inputs: the frontend and the
        relocalization; the state (and carry) buffers hold its result.
        Returns (info, valid until the next call, and the new lost flag as
        a host bool)."""
        self._fill(inputs)
        info, success = self.programs["lost"](self)
        return info, not bool(success)


class Runner:
    """The graph route of ``PTZSlam``'s tracking loops on the card
    (``run_segment_pixels``, ``run_segment_pixels_klt``, ``run_segment``
    and ``step``): one ``TrackGraph`` per (kind, mask presence, image shape
    or K and D, config), kept for the life of the ``PTZSlam``. Each loop is
    its eager counterpart in ``slam.py`` with every frame replayed from the
    graph's programs: bitwise the same results."""

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
        passes the state and carry through; a lost one replays the "lost"
        program and reads its success flag; a tracked one replays "track"
        and reads its flags, then, where they ask for an insert, replays
        "insert+ba" (and reads the lost flag) or "insert". A program's first
        use runs eagerly and captures it. Returns (infos, the last frame's
        lost flag)."""
        infos = []
        for inputs, ok_i in zip(frames, ok):
            if not ok_i:
                infos.append(_clone(slam._skip_info(g.state)))
            elif lost:
                info, lost = g.lost_frame(*inputs)
                infos.append(_clone(info))
            else:
                info, flags, feats = g.track(*inputs)
                infos.append(_clone(info))
                lost, insert, ba = flags.tolist()
                if insert:
                    lost = g.insert(feats, ba)
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
