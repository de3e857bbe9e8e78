"""Ray-sharded BA and the frame-parallel frontend (``ptzjax_torch.dist``) in
gloo worlds of 1, 2, 4 and 8 CPU processes, against the reference's
single-device solver (tests/test_dist.py's problems and tolerances: cams
rtol/atol 1e-5, cost rtol 1e-4, accepted counts within 3).

Each world is spawned once for the module (tests/_torch_dist_worker.py),
joins through a FileStore in a temporary directory (no fixed port, so
xdist workers cannot collide), runs every check on one thread per process
and writes its results; every spawn and every process group has a
timeout, so a stuck rendezvous fails the tests instead of hanging them."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ptzjax import ba as jba
from ptzjax import synth
from ptzjax.config import SLAMConfig
from ptzjax.geometry import Intrinsics
from tests.test_ba import build_problem

WORLDS = (1, 2, 4, 8)
SPAWN_TIMEOUT_S = 240
REPO = Path(__file__).resolve().parents[1]


def _frames():
    """tests/test_dist.py's 320x180 rendered frames (8, focal ~900)."""
    w, h = 320, 180
    intr = Intrinsics.create(w / 2.0, h / 2.0)
    pano = synth.make_panorama(theta_range=(-0.6, 0.6), phi_range=(-0.3, 0.15), texels_per_rad=1500.0, seed=4)
    cams = synth.make_trajectory(8, pan_amp=0.04, tilt0=-0.04, tilt_amp=0.01, f0=900.0, f_amp=40.0, period=24.0, seed=4)
    imgs = np.stack([synth.render_image(pano, c, intr, w, h) for c in cams]).astype(np.float32)
    return imgs, cams[:, 2].astype(np.float32)


def _spawn(world: int, root: Path) -> list[dict]:
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist_worker", str(r), str(world), str(root)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            assert p.returncode == 0, f"world {world}: a rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def problems():
    main, intr, _, _, _ = build_problem(num_kf=6, num_rays_cap=160, noise=0.5, seed=7)
    pad, pad_intr, _, _, _ = build_problem(num_kf=4, num_rays_cap=150, noise=0.0, seed=9)
    return {"main": (main, intr), "pad150": (pad, pad_intr)}


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    """{world size: [rank results]}, each world run once."""
    inputs = {}
    for name, (prob, intr) in problems.items():
        for field, value in prob._asdict().items():
            inputs[f"{name}.{field}"] = np.asarray(value)
        inputs[f"{name}.intr"] = np.array([float(intr.cx), float(intr.cy)], np.float32)
    inputs["frames.imgs"], inputs["frames.focals"] = _frames()
    cfg = SLAMConfig(image_width=320, image_height=180, max_keypoints=96, descriptor_f_ref=900.0)
    out = {}
    for world in WORLDS:
        root = tmp_path_factory.mktemp(f"world{world}")
        np.savez(root / "inputs.npz", **inputs)
        (root / "frontend_cfg.json").write_text(cfg.to_json())
        out[world] = _spawn(world, root)
    return out


@pytest.fixture(scope="module")
def reference(problems):
    prob, intr = problems["main"]
    return {
        "main20": jba.run(prob, intr, SLAMConfig(ba_iters=20)),
        "robust": jba.run_robust(prob, intr, SLAMConfig(ba_iters=10, ba_huber_px=2.0)),
    }


def _res(rank: dict, tag: str) -> dict:
    return {k.split(".", 1)[1]: v for k, v in rank.items() if k.startswith(tag + ".")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["main20", "robust"])
def test_sharded_matches_reference(worlds, reference, problems, world, tag):
    """Quadratic (20 LM iterations) and Huber IRLS (2 rounds of 10): the
    reference's minimum at every world size."""
    got, want = _res(worlds[world][0], tag), reference[tag]
    np.testing.assert_allclose(got["cams"], np.asarray(want.cams), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(want.cost), rtol=1e-4)
    np.testing.assert_allclose(got["initial_cost"], float(want.initial_cost), rtol=1e-5)
    assert abs(int(got["accepted"]) - int(want.accepted)) <= 3
    m = problems["main"][0].rays.shape[0]
    assert got["rays"].shape[0] % world == 0
    np.testing.assert_allclose(got["rays"][:m], np.asarray(want.rays), rtol=1e-4, atol=1e-5)


def test_shard_count_invariance(worlds):
    costs = [float(_res(worlds[w][0], "main10")["cost"]) for w in WORLDS]
    assert max(costs) - min(costs) < 1e-3 * (1 + max(costs)), costs


@pytest.mark.parametrize("world", WORLDS)
def test_padding_to_shard_multiple(worlds, world):
    """150 rays, not a multiple of 4 or 8: padded with weight-0 rows."""
    got = _res(worlds[world][0], "pad150")
    assert got["rays"].shape[0] == 150 + (-150) % world
    assert float(got["cost"]) < float(got["initial_cost"])
    np.testing.assert_array_equal(got["rays"][150:], 0.0)


def test_two_axis_host_chip_mesh(worlds):
    """A 2 x 2 ("host", "chip") mesh reduces over both axes: the 1-D mesh's
    result."""
    rank0 = worlds[4][0]
    assert tuple(rank0["mesh2.axes"]) == ("host", "chip")
    got, want = _res(rank0, "mesh2d"), _res(rank0, "mesh1d")
    np.testing.assert_allclose(got["cams"], want["cams"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS[1:])
def test_every_rank_holds_the_same_result(worlds, world):
    """tests/test_multihost.py's check: every process returns bitwise the
    same cameras, cost and (gathered) rays."""
    ranks = worlds[world]
    assert [int(r["mesh.rank"]) for r in ranks] == list(range(world))
    for r in ranks[1:]:
        for tag in ("main20", "robust", "pad150"):
            for field in ("cams", "rays", "cost", "initial_cost", "accepted"):
                np.testing.assert_array_equal(r[f"{tag}.{field}"], ranks[0][f"{tag}.{field}"])


def test_world_of_one_is_ba_run(worlds):
    """A one-process world: no collective, bitwise ``ba.run``."""
    rank0 = worlds[1][0]
    assert int(rank0["mesh.size"]) == 1
    got, want = _res(rank0, "main20"), _res(rank0, "plain20")
    for field in want:
        np.testing.assert_array_equal(got[field], want[field])


@pytest.mark.parametrize("world", WORLDS)
def test_frontend_sharded_equals_per_frame(worlds, world):
    """``extract_features_sharded`` (8 frames padded to the world size):
    bitwise the per-frame ``extract_features`` at every world size, on
    every rank."""
    per_frame = worlds[world][0]
    for r in worlds[world]:
        for k in range(8):
            for name in ("xy", "desc", "valid"):
                np.testing.assert_array_equal(r[f"frontend.{name}"][k], per_frame[f"per_frame{k}.{name}"])
        assert r["frontend.xy"].shape[0] == 8

