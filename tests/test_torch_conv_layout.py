"""What the conv kernels' wrapper decides on the host, and the index scheme
the wgmma kernels rest on, both on the CPU.

* `dw_slabs` / `dw_tiles`: the grid of the workspace dW scheme as a pure
  function of (voxels, Ci, Co, number of SMs).
* The halo scheme of `csrc/conv3d.cu`: a tap's operand is a *linear* range of
  the [voxels, C] matrix displaced by the tap's offset (what one TMA box
  fetches, zero outside the array), with the voxels whose neighbour lies
  outside the volume masked out afterwards. Rebuilt here in plain tensor code
  and held to the zero-padded plain versions, bit for bit in float32 sums of
  exact products (integer-valued inputs).
"""

import itertools

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops import conv3d as C

H100_SMS = 132


@pytest.mark.parametrize("ci,co,tiles", [(256, 128, 36), (128, 128, 18),
                                         (72, 136, 36), (24, 40, 9), (8, 16, 9),
                                         (64, 128, 9), (65, 129, 36)])
def test_dw_tiles_counts_stencil_rows_times_channel_tiles(ci, co, tiles):
    assert C.dw_tiles(ci, co) == tiles


def _cost(voxels, ci, co, sms, slabs):
    steps = max(1, -(-voxels // C.VOXELS_PER_STEP))
    waves = -(-C.dw_tiles(ci, co) * slabs // sms)
    return waves * (-(-steps // slabs) + C.SLAB_OVERHEAD_STEPS)


@pytest.mark.parametrize("voxels,ci,co,sms", [
    (100 ** 3, 256, 128, H100_SMS), (100 ** 3, 128, 128, H100_SMS),
    (100 ** 3, 128, 128, 114), (100 ** 3, 512, 256, H100_SMS),
    (20 ** 3, 64, 64, H100_SMS), (5 * 6 * 7, 8, 16, H100_SMS),
    (12 * 13 * 14, 72, 136, H100_SMS), (1, 8, 8, H100_SMS), (64, 8, 8, 1),
    (65, 8, 8, H100_SMS), (10 ** 6, 8, 8, 16)])
def test_dw_slabs_is_the_cheapest_grid_within_its_limits(voxels, ci, co, sms):
    slabs = C.dw_slabs(voxels, ci, co, sms)
    steps = max(1, -(-voxels // C.VOXELS_PER_STEP))
    assert 1 <= slabs <= min(C.MAX_SLABS, steps)
    # every step of the walk belongs to a slab
    assert slabs * -(-steps // slabs) >= steps
    costs = {s: _cost(voxels, ci, co, sms, s)
             for s in range(1, min(C.MAX_SLABS, steps) + 1)}
    assert costs[slabs] == min(costs.values())
    # the smallest slab count among the cheapest: the smallest workspace
    assert slabs == min(s for s, c in costs.items() if c == costs[slabs])
    # a pure function: the same answer again, and ints in, int out
    assert C.dw_slabs(voxels, ci, co, sms) == slabs and isinstance(slabs, int)


@pytest.mark.parametrize("ci,co,slabs", [(256, 128, 11), (128, 128, 22)])
def test_dw_slabs_fills_whole_waves_at_the_policy_convs(ci, co, slabs):
    """At the two 100³ convs on 132 SMs the grid is 396 CTAs, three full
    waves, and each SM walks within 1 % of its share of the steps."""
    assert C.dw_slabs(100 ** 3, ci, co, H100_SMS) == slabs
    grid = C.dw_tiles(ci, co) * slabs
    assert grid % H100_SMS == 0
    steps = -(-100 ** 3 // C.VOXELS_PER_STEP)
    walked = (grid // H100_SMS) * -(-steps // slabs)
    ideal = C.dw_tiles(ci, co) * steps / H100_SMS
    assert walked <= 1.01 * ideal


def test_dw_slabs_grows_the_grid_with_the_card():
    few = C.dw_slabs(100 ** 3, 256, 128, 36)
    many = C.dw_slabs(100 ** 3, 256, 128, 4 * 36)
    assert few == 1 and many == 4


# ------------------------------------------------------------ the halo scheme
def _positions(b, d, h, w):
    idx = torch.arange(b * d * h * w)
    return idx // (h * w) % d, idx // w % h, idx % w


def _linear_tap(flat, off):
    """Row v of the result is row v + off of `flat`, zero outside the array:
    what a TMA box at a displaced row coordinate delivers."""
    n = flat.shape[0]
    out = torch.zeros_like(flat)
    lo, hi = max(0, -off), min(n, n - off)
    if hi > lo:
        out[lo:hi] = flat[lo + off:hi + off]
    return out


def _keep(shape, oz, oy, ox):
    """1 where tap (oz, oy, ox) of the voxel lies inside its own volume."""
    b, d, h, w = shape
    z, y, x = _positions(b, d, h, w)
    ok = ((z + oz - 1 >= 0) & (z + oz - 1 < d) & (y + oy - 1 >= 0)
          & (y + oy - 1 < h) & (x + ox - 1 >= 0) & (x + ox - 1 < w))
    return ok.float()[:, None]


def _int_inputs(shape, ci, co, seed):
    b, d, h, w = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.integers(-4, 5, s).astype(np.float32))
    return mk(b, d, h, w, ci), mk(27, ci, co), mk(b, d, h, w, co)


HALO_SHAPES = [(1, 3, 4, 5), (2, 3, 4, 5), (1, 1, 1, 7), (2, 2, 1, 1),
               (1, 5, 2, 3)]


@pytest.mark.parametrize("shape", HALO_SHAPES)
def test_masked_linear_ranges_give_the_forward(shape):
    """y = Σ_tap keep_tap ∘ (x displaced linearly by the tap) · w_tap: the
    mask falls on rows (output voxels) of the A operand."""
    x, wm, _ = _int_inputs(shape, 3, 4, 0)
    b, d, h, w = shape
    flat = x.reshape(-1, 3)
    y = torch.zeros(flat.shape[0], 4)
    for tap, (oz, oy, ox) in enumerate(itertools.product(range(3), repeat=3)):
        off = ((oz - 1) * h + (oy - 1)) * w + ox - 1
        y += (_keep(shape, oz, oy, ox) * _linear_tap(flat, off)) @ wm[tap]
    assert torch.equal(y.reshape(b, d, h, w, 4), C.conv3d_same_reference(x, wm))


@pytest.mark.parametrize("shape", HALO_SHAPES)
def test_masked_linear_ranges_give_the_weight_gradient(shape):
    """dW_tap = (keep_tap ∘ x displaced linearly)^T · dy: the voxel is the K
    index, so the same mask falls on columns of the A operand."""
    x, _, dy = _int_inputs(shape, 3, 4, 1)
    _, d, h, w = shape
    flat, g = x.reshape(-1, 3), dy.reshape(-1, 4)
    dw = []
    for oz, oy, ox in itertools.product(range(3), repeat=3):
        off = ((oz - 1) * h + (oy - 1)) * w + ox - 1
        dw.append((_keep(shape, oz, oy, ox) * _linear_tap(flat, off)).t() @ g)
    assert torch.equal(torch.stack(dw), C.conv3d_dw_reference(x, dy))


def test_one_halo_tile_serves_the_three_x_taps():
    """The three x taps of a stencil row read one displaced range at row
    offsets 0, 1, 2: rows v0-1 .. v0+n of the range are all a tile needs."""
    shape, n, v0 = (1, 3, 4, 5), 8, 16
    x, _, _ = _int_inputs(shape, 3, 4, 2)
    _, d, h, w = shape
    flat = x.reshape(-1, 3)
    for oz, oy in itertools.product(range(3), repeat=2):
        row_off = ((oz - 1) * h + (oy - 1)) * w
        halo = _linear_tap(flat, row_off - 1)[v0:v0 + n + 2]   # n + 2 rows
        for ox in range(3):
            tap = _linear_tap(flat, row_off + ox - 1)[v0:v0 + n]
            assert torch.equal(halo[ox:ox + n], tap)
