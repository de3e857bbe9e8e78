"""The port's long soak (``ptzjax_torch.soak.run_soak``) against the same
loop built from ``ptzjax``'s public API, on the CPU, at a size whose caps
make every store run full: 288 frames of a 96-frame periodic stack at
640x360 (``soak.trajectory`` at half the 720p focal), 4 keyframes at most
(a keyframe every 8 frames), 112 map rays for 96 EKF slots, rays culled 10
frames after they were last seen. So the keyframe store evicts, the ray
free list runs full and drops candidates, culls free rows and merges
collapse duplicates; the test asserts that each happened.

Flags equal every frame, poses within 5e-4 rad / 2 px, the occupancy and
the stores' ids and masks equal at every checkpoint, and the resume from
the first checkpoint bitwise the uninterrupted run."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptzjax import checkpoint as jckpt
from ptzjax.frontend import extract_features as j_extract
from ptzjax.geometry import Intrinsics as JaxIntrinsics
from ptzjax.slam import PTZSlam as JaxSlam
from ptzjax_torch import mapstore as tmap
from ptzjax_torch import soak
from tests._torch_port import port_cfg, port_intr, small_cfg

torch.set_num_threads(2)

STACK, CHUNK, FRAMES, EVERY = 96, 24, 288, 96
W, H = 640, 360
SMALL_CAPS = dict(
    max_map_rays=112, max_keyframes=4, keyframe_interval=8, ray_cull_age=10, descriptor_f_ref=1000.0,
)


def _jax_soak(cfg, intr, imgs, cams):
    """``benchmarks/soak.py``'s loop through ``ptzjax``: frame t is stack
    index t mod STACK, in calls of CHUNK; at each checkpoint the occupancy
    and the state on the host. Returns (stacked infos on the host,
    occupancy, {frame: state})."""
    slam = JaxSlam(cfg, intr)
    f0 = j_extract(jnp.asarray(imgs[0]), cfg, use_pallas=False, focal=jnp.asarray(cams[0][2]))
    state = slam.init(*f0, cams[0])
    imgs_d = jnp.asarray(imgs)
    infos, occupancy, states = [], [], {}
    k = 0
    while k < FRAMES:
        s = k % STACK
        state, inf = slam.run_segment_pixels(state, imgs_d[s:s + CHUNK], use_pallas=False)
        infos.append(jax.device_get(inf))
        k += CHUNK
        if k % EVERY == 0:
            occupancy.append({
                "frame": k, "map_rays": int(state.rays.valid.sum()), "keyframes": int(state.kf.count),
                "ekf_slots": int(state.ekf.active.sum()),
            })
            states[k] = jax.device_get(state)
    return type(infos[0])(*(np.concatenate(f) for f in zip(*infos))), occupancy, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both soaks on the same stack; the port's with each store function
    wrapped to count what it did (evictions, dropped candidates, culled and
    merged rays) over the whole call."""
    cams = soak.trajectory(STACK, f0=1000.0, f_amp=125.0)
    imgs, _ = soak.render_stack(cams, W, H)
    intr = JaxIntrinsics.create(W / 2.0, H / 2.0)
    cfg = small_cfg(**SMALL_CAPS)
    events = dict.fromkeys(("evicted", "dropped", "culled", "merged"), 0)
    add_keyframe, add_rays, cull_rays, merge_rays = (
        tmap.add_keyframe, tmap.add_rays, tmap.cull_rays, tmap.merge_rays
    )

    def count_add_keyframe(*a, **kw):
        store, evicted = add_keyframe(*a, **kw)
        events["evicted"] += int(evicted >= 0)
        return store, evicted

    def count_add_rays(store, rays, desc, mask, frame_idx=0):
        new, ids = add_rays(store, rays, desc, mask, frame_idx)
        events["dropped"] += int((mask & (ids < 0)).sum())
        return new, ids

    def count_cull_rays(store, *a, **kw):
        new = cull_rays(store, *a, **kw)
        events["culled"] += int(store.count - new.count)
        return new

    def count_merge_rays(store, *a, **kw):
        new, remap = merge_rays(store, *a, **kw)
        events["merged"] += int(store.count - new.count)
        return new, remap

    out = tmp_path_factory.mktemp("soak")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmap, "add_keyframe", count_add_keyframe)
        mp.setattr(tmap, "add_rays", count_add_rays)
        mp.setattr(tmap, "cull_rays", count_cull_rays)
        mp.setattr(tmap, "merge_rays", count_merge_rays)
        summary = soak.run_soak(
            port_cfg(cfg), port_intr(intr), imgs, cams, frames=FRAMES, chunk=CHUNK,
            checkpoint_every=EVERY, out=str(out), device="cpu",
        )
    with open(out / "frames.jsonl") as f:
        records = [json.loads(line) for line in f]
    ref = _jax_soak(cfg, intr, imgs, cams)
    return {"summary": summary, "records": records, "events": events, "out": out, "ref": ref, "cfg": cfg}


def test_soak_flags_and_poses_match_reference(runs):
    rec, (ref, _, _) = runs["records"], runs["ref"]
    assert [r["frame"] for r in rec] == list(range(FRAMES))
    for key in ("lost", "keyframe", "reloc_success"):
        np.testing.assert_array_equal([r[key] for r in rec], np.asarray(getattr(ref, key)), err_msg=key)
    np.testing.assert_array_equal([r["event"] == "track" for r in rec], ref.event == 0)
    d = np.abs(np.array([r["pose"] for r in rec]) - ref.pose)
    assert d[:, :2].max() < 5e-4 and d[:, 2].max() < 2.0, d.max(0)


def test_soak_stores_match_reference_at_every_checkpoint(runs):
    """The occupancy lines, then the stores' ids and masks read back from
    the port's checkpoint files (``ptzjax.checkpoint`` loads them): the same
    keyframe slots evicted, the same free rows claimed, culled and merged,
    the same ids in the EKF slots."""
    summary, (_, occupancy, states) = runs["summary"], runs["ref"]
    got = [{k: o[k] for k in ("frame", "map_rays", "keyframes", "ekf_slots")} for o in summary["occupancy_checkpoints"]]
    assert got == occupancy and [o["frame"] for o in got] == [96, 192, 288]
    for frame, want in states.items():
        saved = jckpt.load_pytree(os.path.join(runs["out"], f"state_{frame:06d}.npz"), want)
        for name, a, b in (
            ("kf.frame_idx", saved.kf.frame_idx, want.kf.frame_idx), ("kf.valid", saved.kf.valid, want.kf.valid),
            ("kf.ray_ids", saved.kf.ray_ids, want.kf.ray_ids), ("kf.count", saved.kf.count, want.kf.count),
            ("rays.valid", saved.rays.valid, want.rays.valid), ("rays.views", saved.rays.views, want.rays.views),
            ("rays.count", saved.rays.count, want.rays.count), ("ekf.active", saved.ekf.active, want.ekf.active),
            ("ekf.ray_ids", saved.ekf.ray_ids, want.ekf.ray_ids), ("lost", saved.lost, want.lost),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{name} at frame {frame}")


def test_soak_ran_every_store_full(runs):
    """Eviction, a full free list, cull and merge all happened; the keyframe
    count was pinned at its cap at every checkpoint and the map at its
    capacity."""
    summary, events, cfg = runs["summary"], runs["events"], runs["cfg"]
    assert all(v > 0 for v in events.values()), events
    assert summary["keyframe_evictions"] >= 1
    assert summary["keyframe_inserts"] == summary["keyframe_evictions"] + cfg.max_keyframes - 1
    assert all(o["keyframes"] == cfg.max_keyframes for o in summary["occupancy_checkpoints"])
    assert summary["peak_map_rays"] == cfg.max_map_rays
    assert summary["pass"]["store"] and summary["pass"]["lost"] and summary["frames_lost"] == 0


def test_soak_resume_is_bitwise(runs):
    resume = runs["summary"]["resume"]
    assert resume["from"] == EVERY and resume["frames"] == STACK
    assert resume["bitwise"] and resume["max_abs_pose_diff"] == 0.0, resume


def test_soak_summary_and_artifacts(runs):
    """The reference's summary keys, the checkpoints, the final BA, and the
    metric line."""
    summary, out = runs["summary"], runs["out"]
    for key in (
        "frames", "fps", "fps_first_quartile", "fps_last_quartile", "frames_lost", "pan_mae_deg",
        "pan_mae_deg_first_quartile", "pan_mae_deg_last_quartile", "keyframe_inserts", "occupancy_checkpoints",
        "peak_map_rays", "map_ray_capacity", "keyframe_capacity",
    ):
        assert key in summary, key
    assert sorted(os.listdir(out)) == [
        "frames.jsonl", "state_000096.npz", "state_000192.npz", "state_000288.npz", "summary.json",
    ]
    with open(out / "summary.json") as f:
        assert json.load(f)["frames"] == FRAMES
    ba = summary["final_ba"]
    assert np.isfinite(ba["ba_cost_after"]) and ba["ba_cost_after"] <= ba["ba_cost_before"]
    assert all(m["memory_allocated"] is None for m in summary["memory"])   # no card
    line = json.loads(soak.metric_line(summary))
    assert line["metric"] == "long_soak_10k" and line["value"] == round(summary["fps"], 1)


def test_soak_main_needs_the_card_by_default(monkeypatch, tmp_path):
    """No card and no ``--device cpu``: ``main`` raises before it renders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(soak, "render_stack", lambda *a, **kw: pytest.fail("rendered"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--out", str(tmp_path)])
