"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``traffic/``) and the seed, and gives the calls of a run.

A run's frames come from one or two rendered stacks: ``main``, the PTZ
camera's periodic path (``frames.trajectory``) at a phase drawn from the
seed, one period long, so that frame t of the stream is row t mod
``stack``; and, where the mix has ``cuts``, ``away``: frames of another
camera, at a start drawn from the seed, on a second panorama, which the
stream shows during away shots while the main camera's path moves on.
The panoramas are the mix's ``scene`` (their texture seeds), the same for
every run: the seed picks where in the scene the stream starts and runs,
not the scene, so that every seed does the same work. Frame 0 is the ``init`` frame; the
stream the program is fed starts at frame 1.

A call is a run of consecutive frames from one stack: calls end at
multiples of ``chunk`` frames, at the end of the main stack, and at shot
boundaries. A closed loop sends the next call when the last returns; an
open loop sends each call at its due time (``rate_fps`` frames a second,
from the window's start). The shot lengths are the mix's lists, in an
order the seed draws anew every cycle, so every seed does the same work
in another order.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from ptzbench import frames


class Call(NamedTuple):
    """One call: ``count`` frames from the stack ``source`` from row
    ``row``, the stream's frames ``first`` .. ``first + count - 1``, due
    ``due_s`` after the window's start (open loop; None in a closed loop),
    and its tags: "away" (an away shot's frames), "return" (the first main
    frames after an away shot)."""

    source: str
    row: int
    count: int
    first: int
    due_s: float | None
    tags: tuple


class Traffic:
    """The calls of one run of ``mix`` under ``seed``."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.chunk = int(mix["chunk"])
        self.rate = mix.get("rate_fps")
        if mix["loop"] not in ("closed", "open") or (mix["loop"] == "open") != (self.rate is not None):
            raise ValueError(f"traffic: loop {mix['loop']!r} with rate_fps {self.rate!r}")
        self.rng = np.random.default_rng([int(seed), 17])
        self.scene = {k: int(v) for k, v in mix["scene"].items()}
        path = mix["path"]
        self.stack = int(path["stack"])
        self.phase = int(self.rng.integers(self.stack))
        self.cuts = mix.get("cuts")
        if self.cuts is not None:
            a = self.cuts["away_path"]
            self.away_stack = int(a["frames"])
            if max(self.cuts["away"]) > self.away_stack:
                raise ValueError("traffic: an away shot is longer than the away stack")

    def main_poses(self) -> np.ndarray:
        """(stack, 3) poses of the main stack: row r is stream frame t with
        t mod stack = r."""
        return frames.trajectory(self.mix["path"], self.stack, self.phase)

    def away_poses(self) -> np.ndarray | None:
        """(frames, 3) poses of the away stack: a start drawn uniformly from
        the mix's box, then a constant drift a frame."""
        if self.cuts is None:
            return None
        a = self.cuts["away_path"]
        lo, hi = np.asarray(a["start_lo"], np.float64), np.asarray(a["start_hi"], np.float64)
        start = lo + (hi - lo) * self.rng.random(3)
        drift = np.asarray(a["drift"], np.float64)
        return (start + drift * np.arange(self.away_stack)[:, None]).astype(np.float32)

    def _shots(self) -> Iterator[tuple[str, int, int]]:
        """(source, frames, away-stack offset) of each shot, forever: one
        main shot (endless without cuts), then alternately away and main,
        each cycle's lengths in a new order."""
        if self.cuts is None:
            yield "main", -1, 0
            return
        while True:
            main = self.rng.permutation(self.cuts["main"])
            away = self.rng.permutation(self.cuts["away"])
            for m, a in zip(main, away):
                yield "main", int(m), 0
                yield "away", int(a), int(self.rng.integers(self.away_stack - a + 1))

    def calls(self, first: int = 1) -> Iterator[Call]:
        """The calls of the stream from frame ``first``, forever."""
        t = first
        returning = False
        for source, length, offset in self._shots():
            end = None if length < 0 else t + length
            k = 0
            while end is None or t < end:
                if source == "main":
                    row = t % self.stack
                    n = min(self.chunk - (t % self.chunk), self.stack - row)
                else:
                    row = offset + k
                    n = self.chunk - (t % self.chunk)
                if end is not None:
                    n = min(n, end - t)
                tags = ("away",) if source == "away" else (("return",) if returning else ())
                due = None if self.rate is None else (t - first) / self.rate
                yield Call(source, row, n, t, due, tags)
                returning = False
                t += n
                k += n
            returning = source == "away"

    def warmup(self) -> Call:
        """The set-up's call: the first call of the stream (its result is
        thrown away)."""
        return next(self.calls())
