"""Device selection for the port's entry points.

The port runs on the GPU. The CPU is taken only when the caller names it
(`device="cpu"`, `eval --cpu`), as the tests do; with no GPU and no such
request, an entry point raises instead of silently running on the CPU.
`constant` gives the device tensor of a configuration's constant once, so
that a call on the GPU path does not copy it from the host each time.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

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


_CONSTANTS: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}


def constant(value, dtype: torch.dtype,
             device: Union[str, torch.device]) -> torch.Tensor:
    """`torch.tensor(value, dtype=dtype, device=device)`, made at the first
    call for that (value, dtype, device) and the same tensor after.

    `value` is a Python number, or a tuple of numbers for a 1-d tensor. A
    tensor made from a host scalar on every call costs a pageable
    host-to-device copy, before which the host waits for the stream to
    drain; a constant of the configuration made once costs nothing after
    its first use. Every caller shares the tensor, so none may write to it.
    It is no module buffer: state dicts and checkpoints do not hold it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # repr tells -0.0 from 0.0, and a float from an int, where == would not
    key = (repr(value), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        # never an inference tensor, which autograd could not save
        with torch.inference_mode(False):
            t = torch.tensor(value, dtype=dtype, device=device)
        t = _CONSTANTS.setdefault(key, t)
    return t
