"""k-nearest-neighbour distances (port of `manigaussian_tpu/ops/knn.py`;
simple-knn's `distCUDA2`: the mean squared distance from each point to its
k nearest neighbours, which vanilla 3DGS uses to initialize scales;
ManiGaussian never calls it at run time).

The O(N²) distance matrix a block of rows at a time, |a|² + |b|² − 2a·b
clamped at 0, with the point itself and the padded columns set to +∞, then
the k smallest. The product is true fp32 on the card (TF32 off for it,
whatever the global flag says), as JAX's `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch

_FAR = 1e6  # padding sentinel, far from any real point


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     block: int = 4096) -> torch.Tensor:
    """points [N, 3] → [N] mean squared distance to the k nearest
    neighbours."""
    n = points.shape[0]
    block = min(block, n)
    n_pad = ((n + block - 1) // block) * block
    pts = torch.full((n_pad, points.shape[1]), _FAR, dtype=torch.float32,
                     device=points.device)
    pts[:n] = points.float()
    sq = torch.sum(pts * pts, dim=-1)
    cols = torch.arange(n_pad, device=points.device)
    out = torch.empty(n_pad, dtype=torch.float32, device=points.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, n_pad, block):
            chunk = pts[start:start + block]
            d2 = (sq[start:start + block, None] + sq[None, :]
                  - 2.0 * torch.matmul(chunk, pts.T))
            rows = torch.arange(start, start + block,
                                device=points.device)[:, None]
            d2 = torch.where((rows == cols[None]) | (cols[None] >= n),
                             torch.full_like(d2, float("inf")),
                             torch.clamp(d2, min=0.0))
            near = torch.topk(d2, k, dim=-1, largest=False).values
            out[start:start + block] = torch.mean(near, dim=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out[:n]
