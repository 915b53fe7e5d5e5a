"""Device resolution for the port's entry points.

The port is written for the GPU: an entry point that is given no device
runs on CUDA, and raises when there is none rather than falling back to
the CPU.  Tests and CPU-side tools pass device="cpu" explicitly.  Under
`torchrun` (one process per card) the card is the process's own,
cuda:{LOCAL_RANK}."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> 'cuda', or cuda:{LOCAL_RANK} under torchrun (raises without
    that device); otherwise the given device, checked for availability."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if "LOCAL_RANK" not in os.environ:
            return torch.device("cuda")
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local} but only {torch.cuda.device_count()} "
                               "CUDA device(s) are visible: torchrun --nproc-per-node must not "
                               "exceed the cards")
        return torch.device("cuda", local)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
