"""ptzjax_torch — the PyTorch + CUDA (Hopper) port of ptzjax.

The from-pixels SLAM loop (re-detect and KLT mode), relocalization (map,
keyframe and the native forest), whole-map BA, checkpoints, the run report,
the homography-EKF baseline (``baselines``), the offline mode's sharded
frontend and ray-sharded BA on ``torch.distributed`` (``dist``) and the
experiment CLI (``python -m ptzjax_torch.run``) with its host data
layer (synthetic sequences, annotation I/O, plots) in plain PyTorch, with
the four kernels they reach (Harris+NMS detection, the descriptor window
gather, the fused descriptor matcher and the EKF innovation Cholesky)
written by hand in CUDA C++ under ``csrc/``. A CPU tensor takes each kernel's plain
torch version; a CUDA tensor launches the kernel. The module and function
names follow ``ptzjax`` so each counterpart is easy to find.
"""

from ptzjax_torch.baselines import VOInfo, VOState, init_vo, track_homography_ekf
from ptzjax_torch.config import SLAMConfig
from ptzjax_torch.geometry import (
    Intrinsics,
    back_project_pixels,
    in_view_mask,
    project_jacobians,
    project_rays,
    rays_from_points,
    residuals,
)
from ptzjax_torch.slam import FrameInfo, PTZSlam, SlamState, info_to_dict

__version__ = "0.1.0"
