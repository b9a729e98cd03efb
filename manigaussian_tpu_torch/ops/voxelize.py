"""Point-cloud voxelization: scatter-mean features into a bounded 3D grid.

Port of `manigaussian_tpu/ops/voxelize.py:25-82` (reference
`voxel/voxel_grid.py:104-229`): a (V+2)³ grid whose border cells catch the
out-of-bound points and are cropped after the scatter; channels
[feat_mean(F), xyz_mean(3), normalized index grid(3), occupancy(1)].

Two choices keep it equal to the JAX function:
  * the voxel index is computed with the same float operations in the same
    order (`res` from a true division by V + MIN_DENOMINATOR, then
    floor((p - (min - res)) / (res + MIN_DENOMINATOR))). Dividing a CUDA
    tensor by a Python scalar multiplies by its reciprocal instead, which
    can move a point on a cell boundary into the next cell, so every
    division here is by a tensor;
  * the scatter-sum is deterministic: `index_add_` sums with atomics in an
    order that changes from run to run on CUDA, so the points are sorted by
    cell (stable, so each cell sums its points in their original order, as
    JAX's sequential segment_sum does on the CPU) and each cell's run is
    reduced by `torch.segment_reduce`, with per-cell lengths from an
    integer `bincount`.
"""

from __future__ import annotations

from typing import Optional

import torch

MIN_DENOMINATOR = 1e-12


def voxelize(coords: torch.Tensor, coord_features: Optional[torch.Tensor],
             coord_bounds: torch.Tensor, voxel_size: int = 100) -> torch.Tensor:
    """coords [B, N, 3], coord_features [B, N, F] or None, coord_bounds [6]
    or [B, 6] → [B, V, V, V, F+7] float32, channels last."""
    b, n, _ = coords.shape
    dims = voxel_size + 2
    dev = coords.device
    f32 = dict(dtype=torch.float32, device=dev)

    bounds = torch.as_tensor(coord_bounds, **f32)
    if bounds.ndim == 1:
        bounds = bounds[None].expand(b, 6)
    bb_mins = bounds[:, None, 0:3]
    bb_ranges = bounds[:, None, 3:6] - bb_mins
    res = bb_ranges / torch.tensor(float(voxel_size) + MIN_DENOMINATOR, **f32)
    bb_mins_shifted = bb_mins - res  # one-cell border (voxel_grid.py:179)

    eps = torch.tensor(MIN_DENOMINATOR, **f32)
    floor = torch.floor((coords - bb_mins_shifted) / (res + eps))
    idx = torch.clamp(floor.to(torch.int32), 0, dims - 1).long()   # [B, N, 3]

    values = coords if coord_features is None else torch.cat(
        [coord_features, coords], dim=-1)
    values = torch.cat([values, torch.ones(b, n, 1, **f32)], dim=-1)
    c = values.shape[-1]

    flat_idx = (idx[..., 0] * dims + idx[..., 1]) * dims + idx[..., 2]
    batch_off = torch.arange(b, device=dev)[:, None] * dims ** 3
    seg = (flat_idx + batch_off).reshape(-1)
    num_cells = b * dims ** 3

    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=num_cells)
    sums = torch.segment_reduce(values.reshape(-1, c)[order], "sum",
                                lengths=lengths, axis=0, unsafe=True)
    counts = sums[:, -1:]
    mean = sums / torch.clamp(counts, min=1.0)
    grid = mean.reshape(b, dims, dims, dims, c)[:, 1:-1, 1:-1, 1:-1]

    occupied = (grid[..., -1:] > 0).to(torch.float32)

    # normalized per-voxel index coordinates (voxel_grid.py:219-221)
    vs = voxel_size
    ar = torch.arange(vs, **f32)
    index_grid = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                             dim=-1) / torch.tensor(float(vs), **f32)
    index_grid = index_grid[None].expand(b, vs, vs, vs, 3)

    return torch.cat([grid[..., :-1], index_grid, occupied], dim=-1)
