"""The port's voxelizer (manigaussian_tpu_torch/ops/voxelize.py) against the
JAX one: identical occupied voxels, out-of-bounds points and points on cell
boundaries included; values within 1e-6 (sums of the same points, in the
same order, in fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.voxelize import voxelize as jax_voxelize
from manigaussian_tpu_torch.ops.voxelize import voxelize
from tests.torch_port_helpers import assert_close

BOUNDS = np.array([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6], np.float32)


def _points(seed, b, n, v):
    rng = np.random.default_rng(seed)
    lo, hi = BOUNDS[:3], BOUNDS[3:]
    span = hi - lo
    pts = lo + rng.uniform(-0.2, 1.2, (b, n, 3)) * span     # ~1/3 out of bounds
    # points exactly on cell boundaries, where float order decides the cell
    k = n // 4
    cells = rng.integers(0, v + 1, (b, k, 3)).astype(np.float32)
    res = span / np.float32(v)
    pts[:, :k] = lo + cells * res
    pts[:, -4:] = [[50.0, -50.0, 3.0], [-9.0, 0.0, 1.0], [0.2, 0.0, 1.1],
                   [0.7, 0.5, 1.6]]                        # far away, corners
    feats = rng.uniform(-1, 1, (b, n, 3))
    return pts.astype(np.float32), feats.astype(np.float32)


@pytest.mark.parametrize("b,n,v,per_batch_bounds", [
    (1, 4096, 20, False),
    (2, 3000, 16, True),
    (1, 2048, 100, False),
])
def test_voxelize_matches_jax(b, n, v, per_batch_bounds):
    pts, feats = _points(b * 7 + v, b, n, v)
    bounds = np.tile(BOUNDS, (b, 1)) if per_batch_bounds else BOUNDS
    ref = np.asarray(jax_voxelize(jnp.asarray(pts), jnp.asarray(feats),
                                  jnp.asarray(bounds), v))
    out = voxelize(torch.from_numpy(pts), torch.from_numpy(feats),
                   torch.from_numpy(bounds), v).numpy()
    assert out.shape == ref.shape == (b, v, v, v, 10)
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])   # occupancy
    assert ref[..., -1].sum() > 0
    assert_close(out, ref, 1e-6)


def test_voxelize_without_features():
    pts, _ = _points(5, 1, 512, 12)
    ref = jax_voxelize(jnp.asarray(pts), None, jnp.asarray(BOUNDS), 12)
    out = voxelize(torch.from_numpy(pts), None, torch.from_numpy(BOUNDS), 12)
    assert out.shape == (1, 12, 12, 12, 7)
    assert_close(out, ref, 1e-6)
