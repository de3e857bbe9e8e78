"""Faults planted in the program, under the harness, for the check to
catch: each a ``program.Program`` whose calls are broken in one way.
``tests/test_bench_check.py`` runs them in every cell on the CPU, and
``calibrate.py --faults`` at a cell's own size on the card. The
exchange between chips has no counterpart: every cell runs on one card.

- ``unchanged``: a step that returns its state unchanged; the poses stay
  at the call's start;
- ``half``: half of the batch left out: of a call of several frames the
  second half is not run, and each of its frames gets the last answer of
  the first half; of one-frame calls every second call is not run, and
  gets the answer before it;
- ``altered``: each frame's answer altered where it is produced: its pan
  moved by ``by`` radians;
- ``insert``: a wrong insert: each keyframe that a call writes is stored
  with its pan moved by ``by`` radians.
"""

from __future__ import annotations

import torch

from ptzbench.program import Program


class Unchanged(Program):
    def call(self, state, carry, imgs):
        _, carry2, infos = super().call(state, carry, imgs[:1])
        n = imgs.shape[0]
        return state, carry2, type(infos)(*(v[:1].expand(n, *v.shape[1:]).clone() for v in infos))


class HalfLeftOut(Program):
    last = None

    def call(self, state, carry, imgs):
        n = imgs.shape[0]
        if n == 1:
            skip, self.last = self.last, None
            if skip is not None:
                return state, carry, skip
            state, carry, infos = super().call(state, carry, imgs)
            self.last = infos
            return state, carry, infos
        state, carry, infos = super().call(state, carry, imgs[: n // 2])
        idx = torch.arange(n).clamp(max=n // 2 - 1)
        return state, carry, type(infos)(*(v[idx] for v in infos))


def altered(by: float):
    class Altered(Program):
        def call(self, state, carry, imgs):
            state, carry, infos = super().call(state, carry, imgs)
            pose = infos.pose.clone()
            pose[:, 0] += by
            return state, carry, infos._replace(pose=pose)

    return Altered


def wrong_insert(by: float):
    class WrongInsert(Program):
        def call(self, state, carry, imgs):
            before = state.kf
            valid0, idx0 = before.valid.clone(), before.frame_idx.clone()
            state, carry, infos = super().call(state, carry, imgs)
            kf = state.kf
            new = kf.valid & (~valid0 | (kf.frame_idx != idx0))
            poses = kf.poses.clone()
            poses[:, 0] += new.to(poses.dtype) * by
            return state._replace(kf=kf._replace(poses=poses)), carry, infos

    return WrongInsert


def make(name: str, by: float = 0.0):
    """The fault ``name`` (see the module's docstring) as a program class;
    ``by`` sizes "altered" and "insert"."""
    if name == "unchanged":
        return Unchanged
    if name == "half":
        return HalfLeftOut
    if name == "altered":
        return altered(by)
    if name == "insert":
        return wrong_insert(by)
    raise ValueError(f"faults: no fault {name!r}")
