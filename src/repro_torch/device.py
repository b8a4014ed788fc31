"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another device. Without a CUDA device and without an explicit
    ``device``, raise instead of silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run its plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
