"""Kernels of the port: plain torch semantics plus the hand-written CUDA
kernels they dispatch to on the card (``harris_nms``, ``window_gather``,
``match``, ``cholesky``, ``flow``, ``descriptor``)."""

from ptzjax_torch.kernels.descriptor import describe_keypoints
from ptzjax_torch.kernels.detect import detect_keypoints, harris_response

__all__ = ["describe_keypoints", "detect_keypoints", "harris_response"]
