"""Where the port runs, and host constants kept on the device.

The port runs on the card unless the caller asks for the CPU (``device="cpu"``
or CPU tensors): ``resolve`` picks the device and never falls back.

Building a small tensor from Python numbers on the card (``torch.tensor(...,
device=...)``) copies pageable host memory, and that copy makes the host
wait for everything queued on the stream: a device sync in the middle of the
per-frame loop. Constants the loop needs every frame are therefore made once
per (values, device) and reused; callers only read them. They are kept
for the life of the process: a captured CUDA graph reads them by address.
"""

from __future__ import annotations

import functools

import torch


def resolve(device=None, like=None) -> torch.device:
    """``device`` if given, else the device of ``like`` if it is a tensor,
    else the card. Raises where there is no CUDA device (no CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; the port runs on the card by default. "
            "Pass device='cpu' to run on the CPU."
        )
    return torch.device("cuda")


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (an array or a tensor) on ``device``: from host memory to the
    card through pinned memory and an asynchronous copy, so that the host
    does not wait for the card."""
    x = torch.as_tensor(x)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


@functools.lru_cache(maxsize=None)
def const(values: tuple, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A read-only (len(values),) tensor on ``device``."""
    return torch.tensor(values, dtype=dtype, device=device)
