"""Depth unprojection (port of `manigaussian_tpu/ops/camera.py:145-170`).

Parity with `depth2pc` (graphics_utils.py:56-78): pixel centers at +0.5,
depth interpreted as z-depth, extrinsic world→camera ([R|t], cam = R x + t).
The rest of the JAX module (novel-view cameras for the renderer) arrives
with the training slice.
"""

from __future__ import annotations

import torch


def depth_to_pointcloud(depth: torch.Tensor, extrinsic_w2c: torch.Tensor,
                        intrinsic: torch.Tensor) -> torch.Tensor:
    """depth [H, W], extrinsic_w2c [4, 4], intrinsic [3, 3] → [H*W, 3]
    world points."""
    h, w = depth.shape
    kw = dict(dtype=torch.float32, device=depth.device)
    y = torch.linspace(0.5, h - 0.5, h, **kw)
    x = torch.linspace(0.5, w - 0.5, w, **kw)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    z = depth
    px = (xx - cx) * z / fx
    py = (yy - cy) * z / fy
    pts_cam = torch.stack([px, py, z], dim=-1).reshape(-1, 3)
    rot = extrinsic_w2c[:3, :3]
    t = extrinsic_w2c[:3, 3]
    # R.T @ (p - t) in row-vector form, a full fp32 product (the JAX `_mm`
    # asks for Precision.HIGHEST; on the card that is PyTorch's default,
    # torch.backends.cuda.matmul.allow_tf32 = False)
    return torch.matmul(pts_cam - t, rot)
