"""Quaternion → rotation matrix (port of
`manigaussian_tpu/ops/gaussian_math.py:40-52`), the one helper of that module
the act path needs (through ops/rotation.py). The splat math arrives with
the training slice."""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) → 3x3 rotation matrix, batched over leading
    dims. Like the reference (forward.cu:128), q is assumed normalized."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return rot.reshape(q.shape[:-1] + (3, 3))
