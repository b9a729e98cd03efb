"""Device selection for the port's entry points.

The port runs on the GPU. The CPU is taken only when the caller names it
(`device="cpu"`, `eval --cpu`), as the tests do; with no GPU and no such
request, an entry point raises instead of silently running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or --cpu) "
                "to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
