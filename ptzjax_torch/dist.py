"""Distributed execution: a device mesh, the frame-parallel frontend and
ray-sharded bundle adjustment on ``torch.distributed``. Port of
``ptzjax/dist.py``.

One process per device: NCCL between cards, gloo on the CPU. The work's
long axis is the map (rays and their observations), so BA shards the
ray-major observation table over the mesh, and each LM iteration:

- builds its rays' normal terms and Schur corrections locally;
- all-reduces (sums) the (3K, 3K) reduced camera system and rhs, and the
  costs, over the mesh (``ba.py``'s ``group``): the reference's ``psum``;
- solves the small camera system (the same on every process) and
  back-substitutes its own rays.

A mesh has the ranks of every process in the world: ``make_mesh`` one
axis ("obs",), ``make_mesh_2d`` two ("host", "chip"), over whose
flattening the rays are sharded. A mesh of one device needs no process
group: that is the unsharded case, with no collective. Every process
issues the same collectives in the same order (the LM loop and the IRLS
rounds have fixed counts), and every process group gets a finite timeout,
so a rank that dies fails the others instead of hanging them.

Several cards on one host::

    torchrun --nproc-per-node N -m ptzjax_torch.run --offline ...
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as tdist

from ptzjax_torch import _device
from ptzjax_torch import ba as balib
from ptzjax_torch.ba import BAProblem, BAResult
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import Intrinsics

AXIS = "obs"
HOST_AXIS = "host"
CHIP_AXIS = "chip"
TIMEOUT_S = 300.0


class Mesh(NamedTuple):
    """The processes the rays are sharded over.

    Attributes:
      axis_names: ("obs",) or ("host", "chip").
      shape: devices along each axis.
      device_mesh: the ``torch.distributed`` DeviceMesh, None for one device.
      group: the process group over every axis (the rays' flattened axis),
        None for one device.
    """

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_mesh: Any = None
    group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        """This process's position along the rays' flattened axis."""
        return 0 if self.group is None else tdist.get_rank(self.group)


def initialize_multihost(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Join the process group: call once per process before any mesh. The
    arguments default to the environment ``torchrun`` sets (``env://``,
    WORLD_SIZE, RANK); ``backend`` defaults to NCCL where there is a card
    and gloo where there is not. With NCCL each process takes the card of
    its LOCAL_RANK."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {} if world_size is None else {"world_size": world_size, "rank": rank}
    tdist.init_process_group(
        backend, init_method=init_method, timeout=datetime.timedelta(seconds=timeout_s), **kwargs
    )


def _world() -> tuple[int, str]:
    """(world size, device type of the mesh); (1, "") without a group."""
    if not tdist.is_available() or not tdist.is_initialized():
        return 1, ""
    return tdist.get_world_size(), "cuda" if tdist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh ("obs",) over every process of the world (``num_devices``
    None or 0), or over one device (``num_devices`` 1: no group, no
    collective)."""
    world, device_type = _world()
    n = num_devices or world
    if n == 1:
        return Mesh((AXIS,), (1,))
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} processes, not {world}")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, (n,), mesh_dim_names=(AXIS,))
    return Mesh((AXIS,), (n,), mesh, mesh.get_group(AXIS))


def make_mesh_2d(num_hosts: int | None = None, chips_per_host: int | None = None) -> Mesh:
    """2-D mesh ("host", "chip") over every process of the world, in rank
    order (rank = host * chips_per_host + chip). ``chips_per_host``
    defaults to the processes of this host (LOCAL_WORLD_SIZE, as torchrun
    sets it), ``num_hosts`` to the rest. The rays shard over both axes
    flattened, so the reduction spans the whole mesh."""
    world, device_type = _world()
    if chips_per_host is None:
        chips_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if num_hosts is None:
        num_hosts = max(1, world // chips_per_host)
    shape = (num_hosts, chips_per_host)
    if math.prod(shape) == 1:
        return Mesh((HOST_AXIS, CHIP_AXIS), shape)
    if math.prod(shape) != world:
        raise ValueError(f"a {num_hosts} x {chips_per_host} mesh needs a world of {math.prod(shape)}, not {world}")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, shape, mesh_dim_names=(HOST_AXIS, CHIP_AXIS))
    # the mesh holds every rank, so its flattened axis is the whole world
    return Mesh((HOST_AXIS, CHIP_AXIS), shape, mesh, tdist.group.WORLD)


def pad_problem_for_mesh(prob: BAProblem, num_shards: int) -> BAProblem:
    """Pad the ray axis to a multiple of the shard count (weight 0)."""
    m = prob.rays.shape[0]
    pad = (-m) % num_shards
    if pad == 0:
        return prob

    def rows(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype, device=x.device)])

    return prob._replace(
        rays=rows(prob.rays), obs_pix=rows(prob.obs_pix), obs_cam=rows(prob.obs_cam),
        obs_w=rows(prob.obs_w),
    )


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """This process's shard: its contiguous block of ray rows (the ray axis
    padded to a multiple of the mesh size first), cameras whole."""
    m = prob.rays.shape[0] // mesh.size
    lo = mesh.rank * m
    return prob._replace(
        rays=prob.rays[lo:lo + m], obs_pix=prob.obs_pix[lo:lo + m],
        obs_cam=prob.obs_cam[lo:lo + m], obs_w=prob.obs_w[lo:lo + m],
    )


def _all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``x`` concatenated along the first axis, in mesh
    order."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    tdist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def extract_features_sharded(imgs, cfg: SLAMConfig, mesh: Mesh, masks=None, focals=None, device=None):
    """Frame-parallel feature extraction over the mesh. The frame axis is
    padded to a multiple of the mesh size (repeating the last frame, mask
    and focal); each process runs ``frontend.extract_features`` on its
    contiguous block of frames, and the tables are all-gathered and
    trimmed. Each frame's features are those of a per-frame call.

    Args:
      imgs: (T, H, W) float frames (numpy or tensors).
      masks: optional (T, H, W) bool detection masks.
      focals: optional (T,) per-frame focal estimates (zoom-normalized
        descriptors).
      device: by default the device of ``imgs`` if it is a tensor, else the
        card.

    Returns:
      (xy (T, K, 2), desc (T, K, D), valid (T, K)) on every process.
    """
    from ptzjax_torch.frontend import extract_features

    dev = _device.resolve(device, imgs)
    t = len(imgs)
    per = -(-t // mesh.size)
    out = []
    for k in range(mesh.rank * per, (mesh.rank + 1) * per):
        k = min(k, t - 1)                   # the padding repeats the last frame
        out.append(extract_features(
            torch.as_tensor(imgs[k], device=dev), cfg,
            mask=None if masks is None else torch.as_tensor(masks[k], device=dev),
            focal=None if focals is None else float(focals[k]),
        ))
    xy, desc, valid = (torch.stack(list(v)) for v in zip(*out))
    if mesh.group is None:
        return xy[:t], desc[:t], valid[:t]
    xy, desc = _all_gather_rows(xy, mesh), _all_gather_rows(desc, mesh)
    valid = _all_gather_rows(valid.to(torch.uint8), mesh).to(torch.bool)
    return xy[:t], desc[:t], valid[:t]


def run_sharded(prob: BAProblem, intr: Intrinsics, cfg: SLAMConfig, mesh: Mesh) -> BAResult:
    """Ray-sharded LM/Schur BA, the same math as ``ba.run`` (``ba.run_robust``
    when ``cfg.ba_huber_px > 0``, with Huber factors from each process's own
    rays). The problem is padded to a multiple of the mesh size and each
    process solves its shard; the rays are all-gathered, so every process
    returns the padded global result. A mesh of one device is ``ba.run``
    itself: no collective."""
    prob = pad_problem_for_mesh(prob, mesh.size)
    local = prob if mesh.group is None else shard_problem(prob, mesh)
    if cfg.ba_huber_px > 0:
        res = balib.run_robust(local, intr, cfg, group=mesh.group)
    else:
        res = balib.run(local, intr, cfg, group=mesh.group)
    if mesh.group is None:
        return res
    return res._replace(rays=_all_gather_rows(res.rays, mesh))
