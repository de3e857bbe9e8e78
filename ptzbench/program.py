"""The system under test, ``ptzjax_torch``, behind the few calls the
harness makes: the only module of the benchmark that imports it.

``Program`` holds one ``PTZSlam`` and its state for a configuration's
frontend: ``init`` on frame 0, then ``call`` on each call's frames through
the configuration's entry point (``run_segment_pixels`` in re-detect mode,
``run_segment_pixels_klt`` in KLT mode), which returns the call's
``FrameInfo`` on the host: the call's fence. It reads the frame graph's
branch counts (``TrackGraph.counts``) and kernel names for the per-layer
metrics, and nothing else of the program's insides.
"""

from __future__ import annotations

import torch

from ptzjax_torch import _graphs
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.frontend import extract_features
from ptzjax_torch.geometry import Intrinsics
from ptzjax_torch.kernels import _build
from ptzjax_torch.slam import PTZSlam

ENTRIES = {"redetect": "run_segment_pixels", "klt": "run_segment_pixels_klt"}
BRANCHES = _graphs.BRANCHES

# the kernels' names in a device trace (csrc/*.cu), for the roofline readers
KERNELS = {
    "harris_nms": "detect_kernel",
    "describe": "describe_kernel",
    "match": "match_kernel",
    "cholesky": "cholesky_cluster",
    "lk_flow": "lk_flow_kernel",
    "lk_pyramid": "pyramid_kernel",
}


def load_kernels() -> None:
    """Build the kernel library, or load it from the checkout's build cache
    (``build/ptzjax_torch/``)."""
    _build.load()


class Program:
    """One ``PTZSlam`` of ``fields`` (``SLAMConfig``'s fields, the AUTO
    descriptor reference focal already resolved) in ``frontend`` mode, on
    ``device`` (the card; the CPU only for the harness's own tests)."""

    def __init__(self, fields: dict, frontend: str, width: int, height: int, device):
        if frontend not in ENTRIES:
            raise ValueError(f"program: frontend {frontend!r} is not one of {sorted(ENTRIES)}")
        self.frontend = frontend
        self.device = torch.device(device)
        self.cfg = SLAMConfig(**fields)
        self.slam = PTZSlam(self.cfg, Intrinsics.create(width / 2.0, height / 2.0), device=self.device)
        self.entry = getattr(self.slam, ENTRIES[frontend])

    def init(self, img0: torch.Tensor, pose0):
        """``PTZSlam.init`` on frame 0 at its known pose. Returns the
        program's start (state, carry): the carry is KLT mode's (frame 0,
        its xy, its valid), () otherwise."""
        img0 = img0.to(self.device)
        focal = torch.as_tensor(float(pose0[2]), dtype=torch.float32, device=self.device)
        xy, desc, valid = extract_features(img0, self.slam.cfg, focal=focal)
        state = self.slam.init(xy, desc, valid, pose0)
        carry = (img0, xy, valid) if self.frontend == "klt" else ()
        return state, carry

    def call(self, state, carry, imgs):
        """One call on (T, H, W) host frames from (state, carry): returns
        (state, carry, FrameInfo on the host)."""
        if self.frontend == "klt":
            state, infos, xy, valid = self.entry(state, imgs, *carry)
            carry = (imgs[-1], xy, valid)
        else:
            state, infos = self.entry(state, imgs)
        return state, carry, type(infos)(*(v.cpu() for v in infos))

    def branch_counts(self) -> dict:
        """Frames that took each branch of the frame graph so far, summed
        over the graphs (the graph route on the card; zeros elsewhere)."""
        out = dict.fromkeys(BRANCHES, 0)
        runner = self.slam._graphs
        for g in ([] if runner is None else runner.graphs.values()):
            for name, n in g.counts.items():
                out[name] += n
        return out

    def warm_up(self, state, carry, imgs) -> None:
        """One call whose result is thrown away and whose launches are not
        counted: on the card it captures the frame graph."""
        _graphs.captured_rise(lambda: self.call(state, carry, imgs))

    def close(self) -> None:
        """Drop the ``PTZSlam`` and its graphs' memory pools."""
        self.slam = self.entry = None
