"""`jax.image.resize(..., method="bilinear")` on channels-last images.

JAX's bilinear resize samples at half-pixel centres with a triangle kernel
whose width grows with the scale when it shrinks (it antialiases), and
renormalizes the weights at the border. That is `F.interpolate(mode=
"bilinear", align_corners=False)` when it enlarges, and the same with
`antialias=True` when it shrinks (tests/test_torch_foundation.py holds both
directions against JAX).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x [B, H, W, C] → [B, size[0], size[1], C]."""
    h, w = x.shape[1:3]
    if (h, w) == tuple(size):
        return x
    shrink = size[0] < h or size[1] < w
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=shrink)
    return out.permute(0, 2, 3, 1)
