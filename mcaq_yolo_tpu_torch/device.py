"""Device resolution for the port's entry points.

The port is written for the GPU: an entry point that is given no device
runs on CUDA, and raises when there is none rather than falling back to
the CPU.  Tests and CPU-side tools pass device="cpu" explicitly."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> 'cuda' (raises without a CUDA device); otherwise the given
    device, checked for availability."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
