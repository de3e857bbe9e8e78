"""One rank of a gloo world for tests/test_torch_dist.py:

    python -m tests._torch_dist_worker <rank> <world size> <directory>

It joins the world through a FileStore in ``<directory>`` (so no port is
fixed), runs every check of ``JOBS`` on the inputs in
``<directory>/inputs.npz`` and writes its results to
``<directory>/rank<rank>.npz``. It imports no jax."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ptzjax_torch import ba, dist
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics

TIMEOUT_S = 120.0


def _problem(inputs, name: str) -> tuple[ba.BAProblem, Intrinsics]:
    arrays = [torch.from_numpy(inputs[f"{name}.{f}"]) for f in ba.BAProblem._fields]
    return ba.BAProblem(*arrays), Intrinsics.create(*inputs[f"{name}.intr"])


def _result(out: dict, tag: str, res: ba.BAResult) -> None:
    for field, value in res._asdict().items():
        out[f"{tag}.{field}"] = value.numpy()


def _decisions(prob: ba.BAProblem, intr: Intrinsics, cfg: SLAMConfig, mesh, inputs, tag: str) -> np.ndarray:
    """(S, 3) accept (1) / reject (0) of one ``ba.run_lm`` step from each
    state of the reference's LM trajectory (cameras, rays, weights, lambda)
    with each of its three comparator costs, on this process's shard."""
    trace = {f: inputs[f"trace.{tag}.{f}"] for f in ("cams", "rays", "obs_w", "lam", "comparators")}
    out = np.zeros(trace["comparators"].shape, np.int32)
    for k, comparators in enumerate(trace["comparators"]):
        state = prob._replace(**{f: torch.from_numpy(trace[f][k]) for f in ("cams", "rays", "obs_w")})
        local = dist.pad_problem_for_mesh(state, mesh.size)
        if mesh.group is not None:
            local = dist.shard_problem(local, mesh)
        for j, cost in enumerate(comparators):
            lm = ba.LMState(
                cams=local.cams, rays=local.rays, lam=torch.tensor(trace["lam"][k]),
                cost=torch.tensor(cost), accepted=torch.zeros((), dtype=torch.int32),
                iterations=torch.zeros((), dtype=torch.int32),
            )
            out[k, j] = int(ba.run_lm(local, intr, cfg, lm, 1, group=mesh.group).accepted)
    return out


def main(rank: int, world: int, root: Path) -> None:
    torch.set_num_threads(1)
    dist.initialize_multihost(
        f"file://{root / 'store'}", world_size=world, rank=rank, backend="gloo", timeout_s=TIMEOUT_S
    )
    inputs = np.load(root / "inputs.npz")
    out: dict = {}
    mesh = dist.make_mesh()
    out["mesh.size"], out["mesh.rank"] = np.array(mesh.size), np.array(mesh.rank)
    prob, intr = _problem(inputs, "main")
    for iters in (20, 10):
        _result(out, f"main{iters}", dist.run_sharded(prob, intr, SLAMConfig(ba_iters=iters), mesh))
    robust = SLAMConfig(ba_iters=10, ba_huber_px=2.0)
    _result(out, "robust", dist.run_sharded(prob, intr, robust, mesh))
    for tag, cfg in (("main20", SLAMConfig(ba_iters=20)), ("robust", robust)):
        out[f"{tag}.decisions"] = _decisions(prob, intr, cfg, mesh, inputs, tag)
    pad, pad_intr = _problem(inputs, "pad150")
    _result(out, "pad150", dist.run_sharded(pad, pad_intr, SLAMConfig(ba_iters=8), mesh))
    if world == 4:
        mesh2 = dist.make_mesh_2d(num_hosts=2, chips_per_host=2)
        out["mesh2.axes"] = np.array(mesh2.axis_names)
        _result(out, "mesh2d", dist.run_sharded(prob, intr, SLAMConfig(ba_iters=15), mesh2))
        _result(out, "mesh1d", dist.run_sharded(prob, intr, SLAMConfig(ba_iters=15), mesh))
    if world == 1:
        # no collective: bitwise the unsharded solver in the same process
        _result(out, "plain20", ba.run(prob, intr, SLAMConfig(ba_iters=20)))
    cfg = SLAMConfig.from_json((root / "frontend_cfg.json").read_text())
    feats = dist.extract_features_sharded(
        inputs["frames.imgs"], cfg, mesh, focals=inputs["frames.focals"], device="cpu"
    )
    for name, value in zip(("xy", "desc", "valid"), feats):
        out[f"frontend.{name}"] = value.numpy()
    if rank == 0:
        # the per-frame frontend, in this process's thread setting
        for k, img in enumerate(inputs["frames.imgs"]):
            one = extract_features(torch.from_numpy(img), cfg, focal=float(inputs["frames.focals"][k]))
            for name, value in zip(("xy", "desc", "valid"), one):
                out[f"per_frame{k}.{name}"] = value.numpy()
    np.savez(root / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
