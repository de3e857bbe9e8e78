"""The tracking loops on the card as CUDA graphs: every frame of the
re-detect loop (``run_segment_pixels``), the KLT loop
(``run_segment_pixels_klt``) and the features loop (``run_segment`` and
``step``) is one launch of a frame graph over static buffers, which picks
the frame's branch on the card; a call reads the card once, at its end.

This is how the port carries over the reference's single device program
(``ptzjax/slam.py``: ``jax.jit`` of a ``lax.scan`` over ``_frame_step``,
whose ``lax.cond``s pick relocalize or track, and insert or not). The
frame's branches, split where the reference's conds are:

- "lost": the frontend (re-detect: kernels A and F, the top-k; KLT: the
  pyramids, kernel E, the refill detection with A and the descriptors with
  F; features: none) and the lost branch (``slam._relocalize_step``: C and
  the pose solve, then the re-seed and the stay-lost step selected on the
  device);
- "track": the frontend, the track step (``slam._track_step``: kernels C
  and D, the EKF), its keyframe predicates and the windowed BA's predicate
  (``slam._ba_follows``), from which it writes the two insert predicates;
- "insert+ba" and "insert": the insert branch (``slam._insert_step``: C,
  the keyframe and ray stores, and the windowed BA for "insert+ba") on the
  frame's features, copied into buffers of its own.

Each branch is captured as a CUDA graph of its own (one memory pool for
the four), and the frame graph nests them as the reference nests its conds
(``TrackGraph._frame``), through the conditional nodes of
``csrc/graph_cond.cu``: IF(lost) "lost"; IF(not lost) {"track"; IF(insert
and BA) "insert+ba"; IF(insert and not BA) "insert"}. Both outer
predicates are set from one read of the lost flag before either branch
runs (the lost branch writes it); the next frame reads the flag that the
BA's drift watchdog may have set. Each branch copies its FrameInfo into
the frame's info buffer and stamps its stages into the graph's stats buffer
(``_trace``), whose last stamp adds 1 to the branch's entry of ``taken``;
the frame graph stamps the frame's first and last boundary around its IF
nodes.

A ``TrackGraph`` owns static buffers: the frame's inputs (the image and the
mask where the frames have one, or the features), the carry of KLT mode
(the previous image and keypoint table), the whole ``SlamState``, the
insert's features, the insert predicates, the info and the stats buffer
(``taken`` and the stamps). A call copies the caller's state (and carry)
in; each frame copies its inputs in and launches the frame graph. A
branch's tail copies the fields it changed back into the state buffers,
and in KLT mode the frame's image and table into the carry (the tracked
and the lost frame both move it on). The call
returns fresh tensors: the caller's state and carry are never written, so
an earlier state replayed later (the forest's rewind) gives the same
result. Its one read of the card, at its end, gives the final lost flag
and the used part of the stats buffer: ``taken``, from which the launch
counters are credited (the rise of each branch's capture times the frames
that took it: ``captured_rise``, ``credit``), and the call's stamps, which
go into its record of host spans (``_trace.Call``).

At its first use the frame program runs every branch eagerly, once, on a
stream of its own and on a copy of the buffers (the results are thrown
away, the launches not counted): that creates, from the ordinary allocator
and before the captures, what the branches' kernels keep between calls:
the cuBLAS and cuSOLVER handles, the kernels' shared-memory attributes and
D's cluster query, F's spatial table, ``_device.const``'s constants and the
wrappers' workspaces, which are keyed by (device, stream). The captures
then run on the same stream and launch nothing.

No fallback: a capture, instantiation or launch error raises; a failed
capture names its branch and keeps the first error it met.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import weakref

import torch

from ptzjax_torch import _device, _trace, baselines, slam
from ptzjax_torch.checkpoint import tree_flatten
from ptzjax_torch.frontend import extract_features, track_features
from ptzjax_torch.kernels import _build, cholesky, descriptor, flow, harris_nms, match, window_gather

# every launch counter of the kernel wrappers, as (module, attribute)
COUNTERS = (
    (harris_nms, "launches"), (harris_nms, "masked_launches"), (window_gather, "launches"),
    (match, "launches"), (cholesky, "launches"), (flow, "launches"), (descriptor, "launches"),
    (flow, "pyramid_launches"),
)

# the frontends a graph may hold
KINDS = ("redetect", "klt", "features")

# the branches of the frame program, in the order of their entries in ``taken``
BRANCHES = _trace.BRANCHES


def _counts() -> tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def captured_rise(capture) -> tuple[int, ...]:
    """Run ``capture`` (a CUDA-graph capture, during which the wrappers
    count launches that do not happen, or a warm-up whose launches are no
    frame's), put the counters back and return their rise: what one replay
    launches."""
    before = _counts()
    try:
        capture()
        return tuple(a - b for a, b in zip(_counts(), before))
    finally:
        for (mod, name), value in zip(COUNTERS, before):
            setattr(mod, name, value)


def credit(rise: tuple[int, ...], times: int = 1) -> None:
    """Add ``times`` replays' launches to the counters."""
    for (mod, name), n in zip(COUNTERS, rise):
        setattr(mod, name, getattr(mod, name) + n * times)


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


def _capture(fn, stream, what: str, pool=None, keep: bool = False):
    """``fn()`` captured on ``stream`` as a CUDA graph (``keep``: the graph
    kept for ``raw_cuda_graph``, not instantiated; ``pool``: a memory pool
    shared with other captures). Returns (graph, fn's outputs, the launch
    counters' rise). A failed capture raises naming ``what`` and keeps the
    first error it met: the one ``fn`` raised, or the invalidation of the
    capture that ``fn`` left behind, before the end of the capture reports
    its own."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    first: list = []
    out: list = []

    def body():
        try:
            out.append(fn())
            status = ctypes.c_int(-1)
            _build.check(_build.load().ptz_capture_status(stream.cuda_stream, ctypes.byref(status)), what)
            if status.value != 1:
                raise RuntimeError(f"the capture was invalidated (cudaStreamCaptureStatus {status.value})")
        except BaseException as err:
            first.append(err)
            raise

    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
            rise = captured_rise(body)
    except BaseException as err:
        cause = first[0] if first else err
        raise RuntimeError(f"the CUDA-graph capture of {what} failed: {cause!r}") from cause
    return graph, out[0], rise


class Program:
    """One device program: ``fn(owner)`` (it reads the owner's buffers and
    writes its results back into them) runs eagerly on a stream of its own
    at its first use, which is then captured as a CUDA graph; every later
    use replays the graph and credits its launches. Returns what ``fn``
    returns (from a replay: the graph's outputs, valid until the next
    replay). A program holds no reference to its owner."""

    def __init__(self, fn, device, name: str):
        self.fn, self.device, self.name = fn, device, name
        self.replay = None      # the graph's replay, once captured
        self.capture_s = None   # capture + instantiation, seconds
        self.pool_bytes = None  # memory_reserved's growth over the capture
        self._out = None        # the graph's outputs
        self._rise: tuple[int, ...] = ()
        self._keep = ()         # the graph and the workspaces its kernels use

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
        with _set_up(self, self.device):
            graph, self._out, self._rise = _capture(lambda: self.fn(owner), stream, self.name)
        self._keep = (graph, _workspaces())
        self.replay = graph.replay
        return out


def _workspaces():
    """The wrappers' workspaces as they are: a graph keeps the ones it was
    captured with (a later warm-up on a stream of the same key may replace
    one)."""
    return dict(harris_nms._workspace), dict(match._workspace)


@contextlib.contextmanager
def _set_up(prog, device):
    """Times a block of captures into ``prog.capture_s`` and its memory
    pools' growth into ``prog.pool_bytes``. A capture empties the
    allocator's cache first; so does the reading before it, so that the
    growth is the graphs' pools."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    yield
    prog.capture_s = time.perf_counter() - t0
    prog.pool_bytes = torch.cuda.memory_reserved(device) - reserved


class _Assembly:
    """A CUDA graph assembled from captured graphs and IF nodes
    (``csrc/graph_cond.cu``), then instantiated and launched. ``cond`` and
    ``branch`` are the frame program's two operations
    (``TrackGraph._frame``): each appends to the graph it is called in,
    after the node before."""

    def __init__(self, graphs: dict, stats: torch.Tensor):
        self.lib, self.graphs, self.stats, self.device = _build.load(), graphs, stats, stats.device
        root = ctypes.c_void_p()
        self._check(self.lib.ptz_graph_create(ctypes.byref(root)), "create")
        self.exec = ctypes.c_void_p()
        self._at = (root, ctypes.c_void_p())   # (graph, last node): where the next node goes
        weakref.finalize(self, self.lib.ptz_graph_destroy, root, self.exec)

    def _check(self, err: int, what: str) -> None:
        _build.check(err, f"the frame graph ({what})")

    def _handle(self, graph) -> int:
        h = ctypes.c_ulonglong()
        self._check(self.lib.ptz_graph_handle(graph, ctypes.byref(h)), "handle")
        return h.value

    def cond(self, pred: torch.Tensor, then, otherwise=None) -> None:
        """One kernel that reads the () bool ``pred`` and sets the handles
        of an IF node whose body is ``then()`` and, with ``otherwise``, of an
        IF node on its negation."""
        graph, last = self._at
        bodies = [fn for fn in (then, otherwise) if fn is not None]
        handles = [self._handle(graph) for _ in bodies]
        self._check(self.lib.ptz_graph_add_set(
            graph, ctypes.byref(last), handles[0], handles[-1], len(bodies) - 1, pred.data_ptr()
        ), "set")
        for handle, fn in zip(handles, bodies):
            body = ctypes.c_void_p()
            self._check(self.lib.ptz_graph_add_if(graph, ctypes.byref(last), handle, ctypes.byref(body)), "if")
            self._at = (body, ctypes.c_void_p())
            fn()
            self._at = (graph, last)

    def stamp(self, name: str) -> None:
        """A kernel node of the stamp ``name`` (``_trace.STAMPS``)."""
        graph, last = self._at
        self._check(
            self.lib.ptz_graph_add_stamp(graph, ctypes.byref(last), _trace.INDEX[name], self.stats.data_ptr()),
            f"the stamp {name!r}",
        )

    def branch(self, name: str) -> None:
        """A child-graph node holding the captured branch ``name``."""
        graph, last = self._at
        self._check(
            self.lib.ptz_graph_add_child(graph, ctypes.byref(last), self.graphs[name].raw_cuda_graph()),
            f"the {name!r} branch in its IF node",
        )

    def instantiate(self) -> None:
        result, node = ctypes.c_int(), ctypes.c_int()
        err = self.lib.ptz_graph_instantiate(
            self._at[0], ctypes.byref(self.exec), ctypes.byref(result), ctypes.byref(node), self.device.index
        )
        if err:
            raise RuntimeError(
                f"the frame graph's instantiation failed: CUDA error {err} "
                f"({self.lib.ptz_error_string(err).decode()}), cudaGraphInstantiateResult {result.value}, "
                f"at a node of cudaGraphNodeType {node.value}"
            )

    def launch(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        self._check(self.lib.ptz_graph_launch(self.exec, self.device.index, stream), "launch")


def _every(pred, then, otherwise=None) -> None:
    """The frame program's ``cond`` for its warm-up: every branch runs."""
    then()
    if otherwise is not None:
        otherwise()


class FrameProgram:
    """The frame graph of a ``TrackGraph``: its branches (``BRANCHES``)
    each captured at the first use, after a warm-up of all of them, and
    assembled with IF nodes as ``TrackGraph._frame`` nests them. A call
    launches it (with no host read); ``rise[name]`` is what one run of the
    branch ``name`` launches. Holds no reference to its owner, so a
    ``TrackGraph`` and its graphs' pool are freed when the last reference
    to it goes."""

    def __init__(self, device):
        self.device = device
        self.replay = None      # the frame graph's launch, once captured
        self.capture_s = None   # the four captures + assembly + instantiation, seconds
        self.pool_bytes = None  # memory_reserved's growth over them
        self.rise: dict = {}
        self._stream = None
        self._keep = ()         # the branch graphs, the assembly and the workspaces

    def __call__(self, owner) -> None:
        if self.replay is None:
            self.warm(owner)
            self.capture(owner)
        self.replay()

    def warm(self, owner) -> None:
        """Every branch once, eagerly, on the program's own stream and on
        the owner's buffers, which are then put back; the launches are not
        counted."""
        cur = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        if cur is not None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream) if cur is not None else contextlib.nullcontext():
            saved = owner._save()
            captured_rise(lambda: owner._frame(_every, owner._branch))
            owner._restore(saved)
        if cur is not None:
            cur.wait_stream(self._stream)

    def capture(self, owner) -> None:
        """Each branch captured on the warm-up's stream into one pool, then
        the frame graph assembled and instantiated; the card's clock is
        calibrated against the host's (``_trace.calibrate``, once a
        device)."""
        graphs = {}
        with _set_up(self, self.device):
            pool = torch.cuda.graph_pool_handle()
            for name in BRANCHES:
                graphs[name], _, self.rise[name] = _capture(
                    lambda: owner._branch(name), self._stream, f"the frame graph's {name!r} branch", pool, keep=True
                )
            assembly = _Assembly(graphs, owner.stats)
            owner._frame(assembly.cond, assembly.branch, assembly.stamp)
            assembly.instantiate()
        self._keep = (graphs, assembly, _workspaces())
        self.replay = assembly.launch
        _trace.calibrate(owner.stats.device)


class TrackGraph:
    """A frame's device program (``FrameProgram``) over static buffers, for
    one frontend (``kind``), input shape, mask presence and config.

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
        self.feats = None   # the insert's (xy, desc, valid), made at the warm-up
        self.info = None    # the frame's FrameInfo, made at the warm-up
        self.inserts = buf((2,), torch.bool)            # (insert and BA, insert and not BA)
        self.stats = _trace.buffer(device)              # the stamps (_trace's layout)
        self.taken = self.stats[:len(BRANCHES)]         # frames that took each branch since the load
        self.counts = dict.fromkeys(BRANCHES, 0)        # frames that took each branch, on the host
        self.launched = 0                               # frame graphs launched since the load
        self.clock = torch.zeros(_trace.LAST + 1, dtype=torch.int64, device=device)  # a "clock" stamp after the read
        self._clock_at = None                           # the host's time of its launch (None: none yet)
        self.program = FrameProgram(device)
        self._tracked = None   # the track branch's features, which the insert copies

    def load(self, state: slam.SlamState, carry=(), then=()) -> None:
        """Copy ``state`` (and in KLT mode the carry: previous image, xy,
        valid) into the buffers, and the (buffer, value) pairs ``then``
        after them; a source that is its buffer already is skipped; zero
        the stats buffer (``taken`` and the stamps). A state field, xy or
        valid of another shape or dtype raises, as does an image of another
        shape (an image's dtype is converted, as every frame's is)."""
        pairs = list(zip(self._bufs, tree_flatten(state)[0]))
        for dst, src in pairs:
            _check_fit(dst, src, "state field")
        if carry:
            carry = [_device.to_device(v, self.device) for v in carry]
            for k, (dst, src) in enumerate(zip(self.carry, carry)):
                _check_fit(dst, src, "KLT carry", dtype=k > 0)
            pairs += zip(self.carry, carry)
        _copy((d, s) for d, s in [*pairs, *then] if s is not d)
        self.stats.zero_()
        self.launched = 0

    def snapshot(self) -> tuple[slam.SlamState, list]:
        """The state buffers and the KLT table (xy, valid) as fresh tensors:
        (state, [xy, valid]) ([] for the other kinds)."""
        leaves = _fresh(self._bufs + list(self.carry[1:]))
        n = len(self._bufs)
        return _rebuild(self.state, iter(leaves[:n])), leaves[n:]

    def _save(self) -> list:
        """What a branch writes, as fresh tensors: for ``_restore``."""
        return _fresh(self._bufs + list(self.carry) + [self.stats])

    def _restore(self, saved: list) -> None:
        _copy(zip(self._bufs + list(self.carry) + [self.stats], saved))

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
        """The tail of a branch: the fields of ``state`` that are not their
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
        _trace.stamp("frontend")
        s2, info, flags = slam._track_step(self.state, *feats, cfg=self.cfg, intr=self.intr)
        self._write_back(s2, tail)
        return info, flags, feats

    def _insert(self, ba: bool) -> None:
        """The insert branch on the insert's feature buffers and the state
        buffers, then the tail, which copies back what it changed: the
        keyframe and ray stores, the EKF's ``cam``, ``cov`` and ``ray_ids``,
        and ``lost``."""
        s = slam._insert_step(self.state, *self.feats, cfg=self.cfg, intr=self.intr, ba=ba)
        self._write_back(s)

    def _lost(self):
        """The lost branch: the frontend on the input buffers, the
        relocalization on the state buffers (both of its outcomes selected
        on the device), then the tail (and in KLT mode the carry's).
        Returns (info, success flag)."""
        feats, tail = self._frontend()
        _trace.stamp("frontend")
        s, info, success = slam._relocalize_step(self.state, *feats, cfg=self.cfg, intr=self.intr)
        _trace.stamp("reloc")
        self._write_back(s, tail)
        return info, success

    def _branch(self, name: str) -> None:
        """What the branch ``name`` runs (and its graph captures): its
        work, stamped stage by stage into the stats buffer (``_trace``), the
        FrameInfo copied into the info buffer (the lost and track branches),
        and the tail's stamp, which adds 1 to its entry of ``taken``."""
        with _trace.into(self.stats, name):
            info = None
            if name == "lost":
                info, _ = self._lost()
            elif name == "track":
                info, flags, self._tracked = self._step()
                insert, ba = flags[1], slam._ba_follows(self.state, self.cfg)
                self.inserts.copy_(torch.stack([insert & ba, insert & ~ba]))
            else:
                if self.feats is None:
                    self.feats = [torch.empty_like(v) for v in self._tracked]
                _copy(zip(self.feats, self._tracked))
                self._insert(ba=name == "insert+ba")
            if info is not None:
                if self.info is None:
                    self.info = type(info)(*(torch.empty_like(v) for v in info))
                _copy(zip(self.info, info))
            _trace.stamp("tail")

    def _frame(self, cond, branch, stamp=None) -> None:
        """The frame program, with the reference's conds
        (``ptzjax/slam.py:_frame_step``) as ``cond(pred, then,
        otherwise=None)``, which runs ``then`` where the () bool ``pred``
        holds and ``otherwise`` where it does not, ``branch(name)``, which
        runs a branch: the lost branch while lost, else the track branch and
        then, on its insert predicates, the insert with or without the
        windowed BA; and ``stamp(name)`` (by default written at once), the
        frame's first and last stamp around them."""
        stamp = stamp or (lambda name: _trace.write(self.stats, name))

        def tracked():
            branch("track")
            cond(self.inserts[0], lambda: branch("insert+ba"))
            cond(self.inserts[1], lambda: branch("insert"))

        stamp("frame.start")
        cond(self.state.lost, lambda: branch("lost"), tracked)
        stamp("frame.end")

    def _fill(self, inputs) -> None:
        for dst, src in zip(self.inputs, inputs):
            if dst is not None:
                dst.copy_(src)

    def launch(self) -> None:
        """The frame program's launch on the input buffers (``_fill``):
        the state (and carry) buffers and ``info`` then hold the frame's
        result."""
        self.launched += 1
        self.program(self)

    def finish(self, rec: _trace.Call) -> bool:
        """The call's one read of the card: a "clock" stamp, then the
        state's lost flag, the last call's second "clock" stamp and the used
        part of the stats buffer, in one copy; then, the card idle, this
        call's second "clock" stamp, the host's time of its launch kept.
        Marks the read's end in ``rec``, bounds the clocks' offset with the
        stamps (``_trace.bound``; the first call after a profiler session
        begins or ends calibrates it anew instead: ``_trace.follow``), adds
        ``taken`` to ``counts``, credits each branch's launches and gives
        ``rec`` the call's stamps on the host's clock. Returns the lost
        flag."""
        used = _trace.ROW0 + 2 * min(self.launched, _trace.ROWS)
        _trace.write(self.stats, "clock")
        lost, clock, *stats = torch.cat(
            [self.state.lost.view(1).to(torch.int64), self.clock[_trace.LAST:], self.stats[:used]]
        ).tolist()
        rec.mark(_trace.READ)
        read, device = rec.host[_trace.READ], self.stats.device
        calibrated = _trace.follow(device, rec.profiled)
        clock_at, self._clock_at = self._clock_at, time.time_ns()
        _trace.write(self.clock, "clock")
        if not calibrated:
            _trace.bound(device, None if clock_at is None else (clock_at, clock), (stats[_trace.LAST], read))
        for name, n in zip(BRANCHES, stats):
            self.counts[name] += n
            if n:
                credit(self.program.rise[name], n)
        rec.launched = self.launched
        rec.read(stats, _trace.offset(device, read))
        return bool(lost)


class Runner:
    """The graph route of ``PTZSlam``'s tracking loops on the card
    (``run_segment_pixels``, ``run_segment_pixels_klt``, ``run_segment``
    and ``step``): one ``TrackGraph`` per (kind, mask presence, image shape
    or K and D, config), kept for the life of the ``PTZSlam``. Each loop is
    its eager counterpart in ``slam.py`` with every frame launched from the
    graph's frame program, and one read of the card a call: bitwise the
    same results. Each call writes its host spans and stamps into a record
    of ``_trace``'s ring (``_trace.Call``)."""

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

    def _loop(self, g: TrackGraph, frames, ok, rec: _trace.Call):
        """The frames (each a tuple of inputs) through ``g``, the state
        loaded: a skipped frame passes the state and carry through; any
        other launches the frame program. ``rec`` takes the host marks from
        the load's end to the read's end, and the call's stamps. Returns
        (infos, the last frame's lost flag, from the call's one read)."""
        ns, marks, infos = time.time_ns, rec.marks, []
        fresh = g.program.replay is None
        rec.mark(_trace.LOADED)
        j = 0
        for inputs, ok_i in zip(frames, ok):
            marks[j] = ns()
            if ok_i:
                g._fill(inputs)
                marks[j + 1] = ns()
                g.launch()
                marks[j + 2] = ns()
                infos.append(_clone(g.info))
            else:
                marks[j + 1] = marks[j + 2] = marks[j]
                infos.append(_clone(slam._skip_info(g.state)))
            j += 3
        rec.mark(_trace.FINISH)
        lost = g.finish(rec)
        rec.captured = fresh and g.program.replay is not None
        return infos, lost

    def _frames(self, imgs, masks):
        imgs = _device.to_device(imgs, self.device)
        masks = None if masks is None else _device.to_device(masks, self.device)
        return ((imgs[i], None if masks is None else masks[i]) for i in range(imgs.shape[0])), imgs

    def run_segment_pixels(self, state: slam.SlamState, imgs, masks, frame_ok, *, cfg, intr):
        """``slam._run_segment_pixels``: returns (fresh state, stacked
        infos, the final state's lost flag)."""
        rec = _trace.begin("redetect", imgs.shape[0])
        frames, imgs = self._frames(imgs, masks)
        rec.mark(_trace.COPIED)
        g = self._graph("redetect", masks is not None, imgs.shape[1:], state, cfg=cfg, intr=intr)
        g.load(state)
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, imgs.shape[0]), rec)
        state = g.snapshot()[0]
        rec.mark(_trace.SNAPPED)
        infos = slam._stack(infos)
        rec.mark(_trace.RETURN)
        return state, infos, lost

    def run_segment_pixels_klt(
        self, state: slam.SlamState, imgs, frame_ok, prev_img, prev_xy, prev_valid, masks, *, cfg, intr,
    ):
        """``slam._run_segment_pixels_klt``: returns (fresh state, stacked
        infos, fresh last xy, fresh last valid, the final state's lost
        flag)."""
        rec = _trace.begin("klt", imgs.shape[0])
        frames, imgs = self._frames(imgs, masks)
        rec.mark(_trace.COPIED)
        g = self._graph(
            "klt", masks is not None, imgs.shape[1:], state, cfg=cfg, intr=intr,
            carry_rows=prev_xy.shape[0],
        )
        g.load(state, carry=(prev_img, prev_xy, prev_valid))
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, imgs.shape[0]), rec)
        state, (xy, valid) = g.snapshot()
        rec.mark(_trace.SNAPPED)
        infos = slam._stack(infos)
        rec.mark(_trace.RETURN)
        return state, infos, xy, valid, lost

    def run_segment(self, state: slam.SlamState, xy_seq, desc_seq, valid_seq, frame_ok, *, cfg, intr):
        """``slam._run_segment`` (features on the card): returns (fresh
        state, stacked infos, the final state's lost flag)."""
        t = xy_seq.shape[0]
        rec = _trace.begin("features", t)
        rec.mark(_trace.COPIED)
        g = self._graph("features", False, (xy_seq.shape[1], desc_seq.shape[2]), state, cfg=cfg, intr=intr)
        g.load(state)
        frames = ((xy_seq[i], desc_seq[i], valid_seq[i]) for i in range(t))
        infos, lost = self._loop(g, frames, slam._frame_flags(frame_ok, t), rec)
        state = g.snapshot()[0]
        rec.mark(_trace.SNAPPED)
        infos = slam._stack(infos)
        rec.mark(_trace.RETURN)
        return state, infos, lost

    def step(self, state: slam.SlamState, xy, desc, valid, *, cfg, intr):
        """``slam._frame_step`` on one frame of features: returns (fresh
        state, its FrameInfo, the new state's lost flag)."""
        rec = _trace.begin("features", 1)
        rec.mark(_trace.COPIED)
        g = self._graph("features", False, (xy.shape[0], desc.shape[1]), state, cfg=cfg, intr=intr)
        g.load(state)
        infos, lost = self._loop(g, [(xy, desc, valid)], [True], rec)
        state = g.snapshot()[0]
        rec.mark(_trace.SNAPPED)
        rec.mark(_trace.RETURN)
        return state, infos[0], lost


class VOGraph:
    """The homography baseline's loop (``baselines.track_homography_ekf``)
    on the card: ``baselines._frame`` replayed from one CUDA graph (a
    ``Program``: the call's first frame runs eagerly, then the capture) over
    static buffers, the carry (cam, cov, xy, desc, valid) and the frame's
    (xy, desc, valid). It has no branch and no host read: the infos stay on
    the device and are stacked once at the end."""

    def __init__(self, like: baselines.VOState, *, cfg, intr):
        self.cfg, self.intr = cfg, intr
        self.carry = [torch.empty_like(v) for v in like]
        self.inputs = [torch.empty_like(v) for v in like[2:]]
        self.program = Program(VOGraph._step, like.cam.device, "the homography baseline's frame")

    def _step(self) -> baselines.VOInfo:
        state, info = baselines._frame(baselines.VOState(*self.carry), *self.inputs, intr=self.intr, cfg=self.cfg)
        _copy(zip(self.carry, state))
        return info

    def run(self, state: baselines.VOState, xy_seq, desc_seq, valid_seq):
        """The frames from ``state``: (fresh final carry, VOInfo stacked
        over T). The caller's state is not written."""
        for dst, src in zip(self.carry, state):
            _check_fit(dst, src, "baseline carry")
        _copy(zip(self.carry, state))
        infos = []
        for i in range(xy_seq.shape[0]):
            _copy(zip(self.inputs, (xy_seq[i], desc_seq[i], valid_seq[i])))
            infos.append(_clone(self.program(self)))
        return baselines.VOState(*_fresh(self.carry)), baselines.VOInfo(*(torch.stack(f) for f in zip(*infos)))
