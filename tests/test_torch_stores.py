"""The map's fixed-capacity stores at and below capacity: ``ptzjax_torch.
mapstore`` against ``ptzjax.mapstore`` on the same seeded numpy inputs, on
the CPU. Each function is one test over its cases: ``add_keyframe`` at
``count == max_keyframes`` (the evicted slot, slot 0 never evicted, ties)
and below it, ``add_rays`` with a full free list (drops) and on rows a cull
freed (the reuse order), ``cull_rays`` with protected ids, ``merge_rays``
with duplicates that EKF slots hold. Indices and masks bitwise; float32
values within 1e-6 relative (they are copies, and come out bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import mapstore as jmap
from ptzjax_torch import mapstore as tmap
from tests._torch_port import n, t

K, F, D, M = 6, 8, 4, 24
WIDTH, HEIGHT = 640.0, 360.0


def _assert_same(got, want):
    """Field by field: integer and bool fields bitwise, float32 within 1e-6
    relative."""
    for name in want._fields:
        a, b = n(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _both(cls_j, cls_t, arrays):
    """The same numpy fields as a ptzjax store and a ptzjax_torch store."""
    return cls_j(*(jnp.asarray(a) for a in arrays)), cls_t(*(t(a) for a in arrays))


def _keyframes(rng, count, poses=None):
    """A keyframe store holding ``count`` rows (the first ``count`` valid)."""
    if poses is None:
        poses = np.stack(
            [rng.uniform(-0.2, 0.2, K), rng.uniform(-0.1, 0.05, K), rng.uniform(900, 1300, K)], -1
        ).astype(np.float32)
    valid = np.arange(K) < count
    return [
        np.where(valid[:, None], poses, 0).astype(np.float32),
        np.where(valid, np.arange(K) * 7, -1).astype(np.int32),
        valid,
        rng.uniform(0, 640, (K, F, 2)).astype(np.float32),
        rng.normal(size=(K, F, D)).astype(np.float32),
        np.where(valid[:, None], rng.integers(-1, M, (K, F)), -1).astype(np.int32),
        valid[:, None] & (rng.random((K, F)) < 0.8),
        np.asarray(count, np.int32),
    ]


def _kf_case(name, rng):
    """(store fields, width/height or None) for each ``add_keyframe`` case."""
    if name == "below_cap":
        return _keyframes(rng, 3), (WIDTH, HEIGHT)
    if name == "at_cap":
        return _keyframes(rng, K), (WIDTH, HEIGHT)
    if name == "at_cap_tie":
        # rows 2 and 4 share a pose: both are as redundant as a row can be,
        # the lower index is evicted
        poses = np.stack([np.linspace(-0.3, 0.3, K), np.full(K, -0.05), np.full(K, 1000.0)], -1)
        poses[4] = poses[2]
        return _keyframes(rng, K, poses.astype(np.float32)), (WIDTH, HEIGHT)
    if name == "at_cap_anchor_most_redundant":
        # slot 0 duplicates slot 1: the most redundant pair, but slot 0 is
        # the BA gauge anchor and stays
        poses = np.stack([np.linspace(-0.5, 0.5, K), np.zeros(K), np.full(K, 1000.0)], -1)
        poses[0] = poses[1]
        return _keyframes(rng, K, poses.astype(np.float32)), (WIDTH, HEIGHT)
    if name == "at_cap_no_geometry":
        return _keyframes(rng, K), None
    raise AssertionError(name)


@pytest.mark.parametrize(
    "case", ["below_cap", "at_cap", "at_cap_tie", "at_cap_anchor_most_redundant", "at_cap_no_geometry"]
)
def test_add_keyframe_matches_reference(case):
    rng = np.random.default_rng(11)
    fields, geom = _kf_case(case, rng)
    js, ts = _both(jmap.KeyframeStore, tmap.KeyframeStore, fields)
    pose = np.array([0.05, -0.04, 1100.0], np.float32)
    xy = rng.uniform(0, 640, (F, 2)).astype(np.float32)
    desc = rng.normal(size=(F, D)).astype(np.float32)
    ray_ids = rng.integers(-1, M, F).astype(np.int32)
    fv = rng.random(F) < 0.7
    kw = {} if geom is None else {"width": geom[0], "height": geom[1]}
    j_new, j_ev = jmap.add_keyframe(js, jnp.asarray(pose), jnp.int32(99), *(jnp.asarray(a) for a in (xy, desc, ray_ids, fv)), **kw)
    t_new, t_ev = tmap.add_keyframe(ts, t(pose), torch.tensor(99, dtype=torch.int32), *(t(a) for a in (xy, desc, ray_ids, fv)), **kw)
    assert int(t_ev) == int(j_ev)
    _assert_same(t_new, j_new)
    if case == "below_cap":
        assert int(t_ev) == -1 and n(t_new.frame_idx)[3] == 99
    elif case == "at_cap_no_geometry":
        assert int(t_ev) == -1 and (n(t_new.frame_idx) != 99).all()   # dropped
    else:
        assert 1 <= int(t_ev) < K and n(t_new.frame_idx)[int(t_ev)] == 99
    if case == "at_cap_tie":
        assert int(t_ev) == 2
    if case == "at_cap_anchor_most_redundant":
        assert int(t_ev) == 1


def _rays(rng, valid):
    return [
        rng.uniform(-0.3, 0.3, (M, 2)).astype(np.float32),
        rng.normal(size=(M, D)).astype(np.float32),
        valid,
        np.where(valid, rng.integers(0, 3, M), 0).astype(np.int32),
        np.asarray(valid.sum(), np.int32),
        np.where(valid, rng.integers(0, 50, M), 0).astype(np.int32),
    ]


def _add_rays_case(name, rng):
    """(store fields, candidate mask) for each ``add_rays`` case."""
    b = 10
    if name == "free_list_full":
        valid = np.ones(M, bool)
        valid[[3, 17, 20]] = False            # 3 free rows, 7 candidates: 4 drop
        return _rays(rng, valid), np.arange(b) % 3 != 1
    if name == "no_free_row":
        return _rays(rng, np.ones(M, bool)), np.ones(b, bool)
    if name == "after_cull":
        # a cull freed scattered rows: the j-th accepted candidate takes the
        # j-th free row, in row order
        fields = _rays(rng, np.ones(M, bool))
        store = tmap.RayStore(*(t(a) for a in fields))
        culled = tmap.cull_rays(
            store._replace(views=torch.zeros(M, dtype=torch.int32)),
            torch.tensor([5, -1, 9], dtype=torch.int32), torch.tensor(60, dtype=torch.int32), 20,
        )
        assert int(culled.count) < M
        return [n(v) for v in culled], rng.random(b) < 0.6
    if name == "sparse_mask":
        return _rays(rng, rng.random(M) < 0.5), rng.random(b) < 0.4
    raise AssertionError(name)


@pytest.mark.parametrize("case", ["free_list_full", "no_free_row", "after_cull", "sparse_mask"])
def test_add_rays_matches_reference(case):
    rng = np.random.default_rng(12)
    fields, mask = _add_rays_case(case, rng)
    js, ts = _both(jmap.RayStore, tmap.RayStore, fields)
    b = mask.shape[0]
    rays = rng.uniform(-0.3, 0.3, (b, 2)).astype(np.float32)
    desc = rng.normal(size=(b, D)).astype(np.float32)
    j_new, j_ids = jmap.add_rays(js, jnp.asarray(rays), jnp.asarray(desc), jnp.asarray(mask), jnp.int32(77))
    t_new, t_ids = tmap.add_rays(ts, t(rays), t(desc), t(mask), torch.tensor(77, dtype=torch.int32))
    np.testing.assert_array_equal(n(t_ids), np.asarray(j_ids))
    _assert_same(t_new, j_new)
    free = np.flatnonzero(~fields[2])
    accepted = np.flatnonzero(mask)[: len(free)]
    # the j-th accepted candidate claims the j-th free row; the rest drop
    np.testing.assert_array_equal(n(t_ids)[accepted], free[: len(accepted)])
    assert (n(t_ids)[np.setdiff1d(np.arange(b), accepted)] == -1).all()
    if case in ("free_list_full", "no_free_row"):
        assert int(t_new.count) == M and (n(t_ids)[mask] == -1).any()


@pytest.mark.parametrize("protected", [[], [-1, -1], [2, 7, -1, 7], list(range(0, M, 2))])
def test_cull_rays_matches_reference(protected):
    rng = np.random.default_rng(13)
    fields = _rays(rng, rng.random(M) < 0.8)
    fields[3] = np.where(rng.random(M) < 0.6, 0, fields[3]).astype(np.int32)   # many views == 0
    js, ts = _both(jmap.RayStore, tmap.RayStore, fields)
    ids = np.asarray(protected + [-1], np.int32)
    j_new = jmap.cull_rays(js, jnp.asarray(ids), jnp.int32(60), 20)
    t_new = tmap.cull_rays(ts, t(ids), torch.tensor(60, dtype=torch.int32), 20)
    _assert_same(t_new, j_new)
    dropped = fields[2] & ~n(t_new.valid)
    assert dropped.any() or len(protected) == M // 2
    assert not dropped[ids[ids >= 0]].any()


def _duplicates(rng):
    """Rays in pairs and triples within the merge radius with agreeing
    descriptors, among isolated ones."""
    base = rng.uniform(-0.3, 0.3, (M, 2)).astype(np.float32)
    desc = rng.normal(size=(M, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    for a, b in ((1, 4), (4, 9), (6, 13), (15, 16), (15, 21), (18, 19)):
        base[b] = base[a] + np.float32(2e-4)
        desc[b] = desc[a]
    valid = np.ones(M, bool)
    valid[19] = False
    return [
        base, desc, valid, rng.integers(0, 3, M).astype(np.int32), np.asarray(valid.sum(), np.int32),
        rng.integers(0, 50, M).astype(np.int32),
    ]


@pytest.mark.parametrize("protected", [None, [-1, -1], [4, 13, -1], [16, 21, 9, 1]])
def test_merge_rays_matches_reference(protected):
    rng = np.random.default_rng(14)
    fields = _duplicates(rng)
    js, ts = _both(jmap.RayStore, tmap.RayStore, fields)
    j_kw, t_kw = {}, {}
    if protected is not None:
        ids = np.asarray(protected, np.int32)
        j_kw["protected_ids"], t_kw["protected_ids"] = jnp.asarray(ids), t(ids)
    j_new, j_remap = jmap.merge_rays(js, 1.5e-3, 0.85, **j_kw)
    t_new, t_remap = tmap.merge_rays(ts, 1.5e-3, 0.85, **t_kw)
    np.testing.assert_array_equal(n(t_remap), np.asarray(j_remap))
    _assert_same(t_new, j_new)
    remap = n(t_remap)
    assert (remap != np.arange(M)).any()                  # something merged
    if protected is not None:
        held = [i for i in protected if i >= 0]
        assert (remap[held] == held).all()                # a slot's ray survives
        assert n(t_new.valid)[held].all()
