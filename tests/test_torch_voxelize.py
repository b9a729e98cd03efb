"""The port's voxelizer (manigaussian_tpu_torch/ops/voxelize.py) against the
JAX one: identical occupied voxels, out-of-bounds points and points on cell
boundaries included, points only in the cropped border cells, empty cells
at both ends of the grid, and two clouds with bounds of their own; values
within 1e-6 (sums of the same points, in the same order, in fp32). The
per-cell counts that bound the scatter-sum's runs are `bincount`'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.voxelize import voxelize as jax_voxelize
from manigaussian_tpu_torch.ops.voxelize import (segment_offsets, segment_sum,
                                                  voxelize)
from tests.torch_port_helpers import assert_close

BOUNDS = np.array([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6], np.float32)


def _bounds(b, per_batch_bounds):
    """[6], or [B, 6]: with "own", each cloud's box shifted and grown."""
    if not per_batch_bounds:
        return BOUNDS
    bounds = np.tile(BOUNDS, (b, 1))
    if per_batch_bounds == "own":
        for i in range(b):
            bounds[i] = np.concatenate([BOUNDS[:3] + 0.1 * i,
                                        BOUNDS[3:] + 0.3 * i])
    return bounds


def _points(seed, b, n, v, layout="mixed", bounds=BOUNDS):
    """"mixed": a third out of bounds, a quarter on cell boundaries, four far
    away or on corners; "border": every point outside the box, so only the
    border cells fill; "inner": every point in the middle half of the box,
    so the cells at both ends of the grid stay empty."""
    rng = np.random.default_rng(seed)
    bounds = np.broadcast_to(bounds, (b, 6))[:, None]
    lo, hi = bounds[..., :3], bounds[..., 3:]
    span = hi - lo
    if layout == "border":
        u = rng.uniform(1.05, 1.5, (b, n, 3))
        u[..., 0] *= np.where(rng.uniform(size=(b, n)) < 0.5, -1, 1)
        pts = (lo + span * 0.5) + u * span * 0.5
    elif layout == "inner":
        pts = lo + rng.uniform(0.25, 0.75, (b, n, 3)) * span
    else:
        pts = lo + rng.uniform(-0.2, 1.2, (b, n, 3)) * span  # ~1/3 out of bounds
        # points exactly on cell boundaries, where float order decides the cell
        k = n // 4
        cells = rng.integers(0, v + 1, (b, k, 3)).astype(np.float32)
        res = span / np.float32(v)
        pts[:, :k] = lo + cells * res
        pts[:, -4:] = [[50.0, -50.0, 3.0], [-9.0, 0.0, 1.0], [0.2, 0.0, 1.1],
                       [0.7, 0.5, 1.6]]                    # far away, corners
    feats = rng.uniform(-1, 1, (b, n, 3))
    return pts.astype(np.float32), feats.astype(np.float32)


@pytest.mark.parametrize("b,n,v,per_batch_bounds,layout", [
    pytest.param(1, 4096, 20, False, "mixed", id="1-4096-20-False"),
    pytest.param(2, 3000, 16, True, "mixed", id="2-3000-16-True"),
    pytest.param(1, 2048, 100, False, "mixed", id="1-2048-100-False"),
    pytest.param(1, 1024, 20, False, "border", id="border-only"),
    pytest.param(1, 1024, 20, False, "inner", id="empty-ends"),
    pytest.param(2, 3000, 16, "own", "mixed", id="2-own-bounds"),
    pytest.param(2, 2000, 16, "own", "inner", id="2-own-bounds-empty-ends"),
])
def test_voxelize_matches_jax(b, n, v, per_batch_bounds, layout):
    bounds = _bounds(b, per_batch_bounds)
    pts, feats = _points(b * 7 + v, b, n, v, layout, bounds)
    ref = np.asarray(jax_voxelize(jnp.asarray(pts), jnp.asarray(feats),
                                  jnp.asarray(bounds), v))
    out = voxelize(torch.from_numpy(pts), torch.from_numpy(feats),
                   torch.from_numpy(bounds), v).numpy()
    assert out.shape == ref.shape == (b, v, v, v, 10)
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])   # occupancy
    occupied = ref[..., -1].sum(axis=(1, 2, 3))
    if layout == "border":
        assert not occupied.any()
    else:
        assert occupied.all()
    if layout == "inner":
        ends = ref[:, [0, -1]][..., -1], ref[:, :, :, [0, -1]][..., -1]
        assert not any(e.any() for e in ends)
    assert_close(out, ref, 1e-6)


@pytest.mark.parametrize("layout", ["mixed", "border", "inner"])
def test_segment_offsets_count_as_bincount(layout):
    """The runs that bound the scatter-sum hold `bincount`'s counts, the
    empty cells at both ends and between included."""
    v, b = 12, 2
    dims = v + 2
    pts, _ = _points(11, b, 700, v, layout)
    res = (BOUNDS[3:] - BOUNDS[:3]) / np.float32(v)
    idx = np.clip(np.floor((pts - (BOUNDS[:3] - res)) / res), 0,
                  dims - 1).astype(np.int64)
    flat = (idx[..., 0] * dims + idx[..., 1]) * dims + idx[..., 2]
    index = torch.from_numpy(flat + np.arange(b)[:, None] * dims ** 3).reshape(-1)
    n = b * dims ** 3
    counts = torch.bincount(index, minlength=n)
    if layout == "inner":
        assert counts[0] == 0 and counts[-1] == 0
    offsets = segment_offsets(torch.sort(index, stable=True).values, n)
    assert offsets.shape == (n + 1,) and offsets[0] == 0
    assert torch.equal(offsets.diff(), counts)
    rows = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (index.shape[0], 4)).astype(np.float32))
    expect = torch.zeros(n, 4).index_add_(0, index, rows)
    assert_close(segment_sum(rows, index, n).numpy(), expect.numpy(), 1e-6)


def test_voxelize_without_features():
    pts, _ = _points(5, 1, 512, 12)
    ref = jax_voxelize(jnp.asarray(pts), None, jnp.asarray(BOUNDS), 12)
    out = voxelize(torch.from_numpy(pts), None, torch.from_numpy(BOUNDS), 12)
    assert out.shape == (1, 12, 12, 12, 7)
    assert_close(out, ref, 1e-6)
