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
    reduced by `torch.segment_reduce`, over the runs that a binary search
    of the sorted indices bounds (`bincount` would size its output from the
    indices' largest, read back to the host).
The divisors are device constants made once (`utils.device.constant`), so
an act on the GPU copies nothing from the host here.
"""

from __future__ import annotations

from typing import Optional

import torch

from manigaussian_tpu_torch.utils.device import constant

MIN_DENOMINATOR = 1e-12


def segment_sum(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of the rows [D, C] that share an index in [0, n), into [n, C]: a
    stable sort of the indices, then `torch.segment_reduce` over each index's
    run, so every sum has a fixed order (`index_add_` accumulates with
    atomics on CUDA, in an order that changes from run to run)."""
    order = torch.argsort(index, stable=True)
    return torch.segment_reduce(rows[order], "sum",
                                offsets=segment_offsets(index[order], n),
                                axis=0, unsafe=True)


def segment_offsets(sorted_index: torch.Tensor, n: int) -> torch.Tensor:
    """Where each index's run starts in `sorted_index` (ascending, in
    [0, n)), and where the last run ends: [n + 1], so that the differences
    are `torch.bincount(sorted_index, minlength=n)`. A binary search on the
    device; on CUDA `bincount` reads the largest index back to the host."""
    return torch.searchsorted(
        sorted_index, torch.arange(n + 1, device=sorted_index.device))


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
    res = bb_ranges / constant(float(voxel_size) + MIN_DENOMINATOR,
                               torch.float32, dev)
    bb_mins_shifted = bb_mins - res  # one-cell border (voxel_grid.py:179)

    eps = constant(MIN_DENOMINATOR, torch.float32, dev)
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

    sums = segment_sum(values.reshape(-1, c), seg, num_cells)
    counts = sums[:, -1:]
    mean = sums / torch.clamp(counts, min=1.0)
    grid = mean.reshape(b, dims, dims, dims, c)[:, 1:-1, 1:-1, 1:-1]

    occupied = (grid[..., -1:] > 0).to(torch.float32)

    # normalized per-voxel index coordinates (voxel_grid.py:219-221)
    vs = voxel_size
    ar = torch.arange(vs, **f32)
    index_grid = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                             dim=-1) / constant(float(vs), torch.float32, dev)
    index_grid = index_grid[None].expand(b, vs, vs, vs, 3)

    return torch.cat([grid[..., :-1], index_grid, occupied], dim=-1)
