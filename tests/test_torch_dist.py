"""Ray-sharded BA and the frame-parallel frontend (``ptzjax_torch.dist``) in
gloo worlds of 1, 2, 4 and 8 CPU processes, against the reference's
single-device solver (tests/test_dist.py's problems and tolerances: cams
rtol/atol 1e-5, cost rtol 1e-4). The LM's accept/reject decisions are held
one step at a time, from each state of the reference's own trajectory,
wherever the reference decides by more than the fp32 noise of a cost
(``_margin``): an accepted-step count would compare near-ties that each
machine rounds its own way.

Each world is spawned once for the module (tests/_torch_dist_worker.py),
joins through a FileStore in a temporary directory (no fixed port, so
xdist workers cannot collide), runs every check on one thread per process
and writes its results; every spawn and every process group has a
timeout, so a stuck rendezvous fails the tests instead of hanging them."""

import os
import subprocess
import sys
from pathlib import Path

import jax
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


CONFIGS = {"main20": SLAMConfig(ba_iters=20), "robust": SLAMConfig(ba_iters=10, ba_huber_px=2.0)}


def _margin(cost: np.ndarray, num_obs: int) -> np.ndarray:
    """The relative margin below which two fp32 evaluations of one BA cost
    may order a candidate differently. The cost sums num_obs weighted
    squared residuals (weights <= 1) of projections < 1,280 px, each
    coordinate within DELTA = 8,000 unit roundoffs u = 2**-24 (5e-4 px:
    the angle difference, tan and cos at 4 ulps, the products and sums; the
    derivation in tests/test_torch_checkpoint.py at 640 px). A residual r
    rounded by delta moves the cost by 2 r delta: with the roundings
    independent and zero-mean, Hoeffding bounds the sum by lam * 2 DELTA *
    sqrt(cost) (lam = 6: probability 1 - 3e-8), plus < num_obs u relative
    for the fp32 sum; twice that for the reference's and the port's
    evaluations. The candidate step's own rounding moves its cost at second
    order near the minimum: the port's and the reference's candidates from
    one state differ by < 1e-5 of the cost on this problem."""
    u = 2.0**-24
    return 2 * (2 * 6 * 8000 * u / np.sqrt(cost) + num_obs * u)


def _reference_lm_trace(prob, intr, cfg: SLAMConfig) -> dict:
    """The reference's LM trajectory one step at a time: ``jba.run_lm(...,
    1)`` chained (its own accept rule moves the state), each state's
    candidate cost from ``jba.lm_iteration`` and ``jba.compute_cost``, with
    ``jba.run_robust``'s Huber rounds where ``cfg`` asks for them. Each
    state is probed against three comparator costs, its cost and its cost
    moved by twice the margin either way: a decision is expected where the
    reference's candidate clears the comparator by more than the margin."""
    step = jax.jit(lambda p, lm: jba.run_lm(p, intr, cfg, lm, 1))
    candidate = jax.jit(lambda p, lm: jba.compute_cost(*jba.lm_iteration(lm.cams, lm.rays, lm.lam, p, intr, cfg), p, intr))
    rounds = cfg.ba_irls_rounds if cfg.ba_huber_px > 0 else 0
    base_w, rows = prob.obs_w, []
    for _ in range(max(rounds, 1)):
        if rounds:
            wh = jba.huber_factors(prob.cams, prob.rays, prob._replace(obs_w=base_w), intr, cfg.ba_huber_px)
            prob = prob._replace(obs_w=base_w * wh)
        lm = jba.init_lm_state(prob, intr, cfg)
        for _ in range(cfg.ba_iters):
            nxt = step(prob, lm)
            rows.append((lm, prob.obs_w, float(candidate(prob, lm)), int(nxt.accepted - lm.accepted)))
            lm = nxt
        prob = prob._replace(cams=lm.cams, rays=lm.rays)
    cost = np.array([float(r[0].cost) for r in rows])
    cand = np.array([r[2] for r in rows])
    margin = _margin(cost, int((np.asarray(prob.obs_w) > 0).sum()))
    comparators = cost[:, None] * (1 + 2 * margin[:, None] * np.array([-1.0, 0.0, 1.0]))
    trace = {
        "cams": np.stack([np.asarray(r[0].cams) for r in rows]),
        "rays": np.stack([np.asarray(r[0].rays) for r in rows]),
        "obs_w": np.stack([np.asarray(r[1]) for r in rows]),
        "lam": np.array([float(r[0].lam) for r in rows], np.float32),
        "comparators": comparators.astype(np.float32),
    }
    expect = cand[:, None] < comparators
    clear = np.abs(cand[:, None] - comparators) > margin[:, None] * cost[:, None]
    # the trajectory's own decisions are the candidates' where they are clear
    own = np.array([r[3] for r in rows], bool)
    np.testing.assert_array_equal(own[clear[:, 1]], expect[clear[:, 1], 1])
    return {"inputs": trace, "expect": expect, "clear": clear}


@pytest.fixture(scope="module")
def lm_traces(problems):
    prob, intr = problems["main"]
    return {tag: _reference_lm_trace(prob, intr, cfg) for tag, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def worlds(problems, lm_traces, tmp_path_factory):
    """{world size: [rank results]}, each world run once."""
    inputs = {}
    for name, (prob, intr) in problems.items():
        for field, value in prob._asdict().items():
            inputs[f"{name}.{field}"] = np.asarray(value)
        inputs[f"{name}.intr"] = np.array([float(intr.cx), float(intr.cy)], np.float32)
    for tag, trace in lm_traces.items():
        for field, value in trace["inputs"].items():
            inputs[f"trace.{tag}.{field}"] = value
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
    return {"main20": jba.run(prob, intr, CONFIGS["main20"]), "robust": jba.run_robust(prob, intr, CONFIGS["robust"])}


def _res(rank: dict, tag: str) -> dict:
    return {k.split(".", 1)[1]: v for k, v in rank.items() if k.startswith(tag + ".")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ["main20", "robust"])
def test_sharded_matches_reference(worlds, reference, lm_traces, problems, world, tag):
    """Quadratic (20 LM iterations) and Huber IRLS (2 rounds of 10): the
    reference's minimum at every world size, and from every state of the
    reference's LM trajectory the reference's accept/reject wherever it
    decides by more than the fp32 margin (``_reference_lm_trace``)."""
    got, want = _res(worlds[world][0], tag), reference[tag]
    np.testing.assert_allclose(got["cams"], np.asarray(want.cams), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["cost"], float(want.cost), rtol=1e-4)
    np.testing.assert_allclose(got["initial_cost"], float(want.initial_cost), rtol=1e-5)
    trace = lm_traces[tag]
    assert trace["expect"][trace["clear"]].any() and not trace["expect"][trace["clear"]].all()
    np.testing.assert_array_equal(got["decisions"].astype(bool)[trace["clear"]], trace["expect"][trace["clear"]])
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

