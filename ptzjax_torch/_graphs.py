"""The re-detect loop on the card as CUDA graphs: each tracked frame is the
replay of one graph that holds the whole frame -- the frontend (kernels A
and F, the top-k), the track step (kernels C and D, the EKF) and the
keyframe predicates -- and one host read of its (lost, insert) flags.

This is how the port carries over the reference's single device program a
frame (``ptzjax/slam.py``: ``jax.jit`` of ``_frame_step``, whose
``lax.cond``s pick track or relocalize and insert or not). A graph cannot
branch, so the frame splits where the reference's conds are: the tracked
step up to its insert predicate (``slam._track_step``) is captured; an
insert (``slam._keyframe``: the insert and the windowed BA) and a lost frame
(``slam._relocalize``) run eagerly after it, as the eager route runs them.
Both are rare: 2 inserts in the 192 frames of the bench sequence.

A ``TrackGraph`` owns static buffers: the image, the mask where the frames
have one, and the whole ``SlamState``. A call copies the caller's state in;
each tracked frame copies its image in and replays. The graph's tail copies
the fields the step changed back into the state buffers, which the next
replay reads; the keyframe store, which tracking only reads, is not copied.
Eager frames read the buffers and copy their results in. The call returns
fresh tensors: the caller's state is never written, so an earlier state
replayed later (the forest's rewind) gives the same result.

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
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.kernels import cholesky, descriptor, flow, harris_nms, match, window_gather

# every launch counter of the kernel wrappers, as (module, attribute)
COUNTERS = (
    (harris_nms, "launches"), (harris_nms, "masked_launches"), (window_gather, "launches"),
    (match, "launches"), (cholesky, "launches"), (flow, "launches"), (descriptor, "launches"),
)


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


def _clone(tree):
    """``tree`` (nested NamedTuples of tensors) as fresh tensors."""
    leaves = tree_flatten(tree)[0]
    fresh = [torch.empty_like(v) for v in leaves]
    _copy(zip(fresh, leaves))
    return _rebuild(tree, iter(fresh))


class TrackGraph:
    """One tracked re-detect frame as a CUDA graph over static buffers, for
    one image shape, mask presence and config."""

    def __init__(self, like: slam.SlamState, shape, masked: bool, *, cfg, intr, device):
        self.cfg, self.intr, self.device = cfg, intr, device
        self._bufs = [torch.empty_like(v, device=device) for v in tree_flatten(like)[0]]
        self.state = _rebuild(like, iter(self._bufs))
        self.img = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        self.mask = torch.empty(tuple(shape), dtype=torch.bool, device=device) if masked else None
        self._replay = None     # the graph's replay, once captured
        self._out = None        # the graph's outputs: (info, flags, (xy, desc, valid))
        self._rise: tuple[int, ...] = ()
        self._keep = ()         # the workspaces the graph's kernels use
        self.capture_s = None   # capture + instantiation, seconds

    def load(self, state: slam.SlamState) -> None:
        """Copy ``state`` into the state buffers (a field that is its buffer
        already is skipped)."""
        pairs = [(d, s) for d, s in zip(self._bufs, tree_flatten(state)[0]) if s is not d]
        for dst, src in pairs:
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"state field {src.dtype} {tuple(src.shape)} does not fit the graph's "
                    f"{dst.dtype} {tuple(dst.shape)} (another config?)"
                )
        _copy(pairs)

    def snapshot(self) -> slam.SlamState:
        """The state buffers as fresh tensors."""
        return _clone(self.state)

    def _step(self):
        """What the graph holds: the frontend on the image buffer, the track
        step and keyframe predicates on the state buffers, then the tail that
        copies the changed fields back."""
        cfg, intr = self.cfg, self.intr
        xy, desc, valid = extract_features(
            self.img, cfg, mask=self.mask, focal=slam._safe_focal(self.state, cfg)
        )
        s2, info, flags = slam._track_step(self.state, xy, desc, valid, cfg=cfg, intr=intr)
        _copy((d, s) for d, s in zip(self._bufs, tree_flatten(s2)[0]) if s is not d)
        return info, flags, (xy, desc, valid)

    def track(self, img, mask):
        """One tracked frame from the image (and mask): (info, flags, (xy,
        desc, valid)), valid until the next call; the state buffers hold the
        tracked state."""
        self.img.copy_(torch.as_tensor(img))
        if self.mask is not None:
            self.mask.copy_(torch.as_tensor(mask))
        if self._replay is None:
            return self._first_frame()
        self._replay()
        credit(self._rise)
        return self._out

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
    """The graph route of ``PTZSlam.run_segment_pixels`` on the card: one
    ``TrackGraph`` per (mask presence, image shape, config), kept for the
    life of the ``PTZSlam``."""

    def __init__(self, device):
        self.device = device
        self.graphs: dict = {}

    def run_segment_pixels(self, state: slam.SlamState, imgs, masks, frame_ok, *, cfg, intr, lost: bool):
        """``slam._run_segment_pixels`` with each tracked frame replayed from
        its graph: bitwise the same results. Returns (fresh state, stacked
        infos, the final state's lost flag)."""
        t = imgs.shape[0]
        ok = slam._frame_flags(frame_ok, t)
        key = (masks is not None, tuple(imgs.shape[1:]), cfg)
        if key not in self.graphs:
            self.graphs[key] = TrackGraph(state, key[1], key[0], cfg=cfg, intr=intr, device=self.device)
        g = self.graphs[key]
        g.load(state)
        infos = []
        for i in range(t):
            mask = None if masks is None else masks[i]
            if not ok[i]:
                infos.append(_clone(slam._skip_info(g.state)))
            elif lost:
                dev = self.device
                xy, desc, valid = extract_features(
                    torch.as_tensor(imgs[i], device=dev), cfg,
                    mask=None if mask is None else torch.as_tensor(mask, device=dev),
                    focal=slam._safe_focal(g.state, cfg),
                )
                s, info, lost = slam._frame_step(g.state, xy, desc, valid, cfg=cfg, intr=intr, lost=True)
                infos.append(_clone(info))
                g.load(s)
            else:
                info, flags, feats = g.track(imgs[i], mask)
                infos.append(_clone(info))
                lost, insert = flags.tolist()
                if insert:
                    s, lost = slam._keyframe(g.state, *feats, cfg=cfg, intr=intr)
                    g.load(s)
        return g.snapshot(), slam._stack(infos), lost
