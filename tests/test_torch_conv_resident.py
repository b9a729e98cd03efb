"""The resident dW scheme's host-side plan and its reduction, on the CPU.

`csrc/conv3d.cu`'s `conv3d_dw_resident_kernel` walks each dW tile (one row of
the stencil × 64 input × 128 output channels) with one thread-block cluster
of S CTAs: rank r walks its slice of the 64-voxel steps, then adds its share
of the tile's partials over the ranks in rank order and writes it. What the
wrapper decides (`dw_resident_plan`: S and the grid from the shapes and the
card's table of co-resident clusters) and the two partitions the kernel
computes (`dw_rank_steps`, `dw_rank_shares`) are pure functions, held here;
the rank-order sum is rebuilt in plain tensor code, through the kernel's
[3][64][128] partial layout and its float4 shares, and held to the plain
version.
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops import conv3d as C

# Clusters of S CTAs (one CTA an SM, a cluster inside one GPC) that a card
# holds at once: what cudaOccupancyMaxActiveClusters reports for the
# resident kernel on an H100 SXM (80GB HBM3, 132 SMs), a card of GPCs of 18
# SMs, one whose non-portable sizes are refused, and a small card.
def _gpc_table(gpcs):
    return {s: sum(g // s for g in gpcs) for s in range(1, C.DW_MAX_CLUSTER + 1)}


H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
        **{s: 7 for s in range(10, 17)}}
TABLES = {"h100": H100, "gpcs_of_18": _gpc_table([18] * 7 + [6]),
          "portable_only": {s: (132 // s if s <= 8 else 0)
                            for s in range(1, C.DW_MAX_CLUSTER + 1)},
          "small": _gpc_table([10, 10, 8])}

# (voxels, Ci, Co): the policy's two 100³ convs and the ragged shapes of
# tests/test_torch_conv_gpu.py (27 voxels: one step, fewer than any S > 1)
SHAPES = [(100 ** 3, 256, 128), (100 ** 3, 128, 128), (5 * 6 * 7, 8, 16),
          (2 * 9 * 10 * 11, 24, 40), (12 * 13 * 14, 72, 136),
          (2 * 12 * 13 * 14, 128, 128), (6 * 7 * 9, 256, 128), (27, 64, 128)]


def _cost(tiles, steps, s, held):
    return -(-tiles // held) * -(-steps // s)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("voxels,ci,co", SHAPES)
def test_plan_picks_a_legal_cluster_and_a_grid_of_tiles_times_s(voxels, ci, co,
                                                               table):
    clusters = TABLES[table]
    plan = C.dw_resident_plan(voxels, ci, co, clusters)
    s, tiles, steps = plan["cluster"], C.dw_tiles(ci, co), C.dw_steps(voxels)
    assert 1 <= s <= C.DW_MAX_CLUSTER and clusters[s] >= 1
    assert plan["clusters_at_once"] == clusters[s]
    assert plan["grid"] == tiles * s
    assert plan["waves"] == -(-tiles // clusters[s])
    assert plan["steps_per_cta"] == -(-steps // s)
    costs = {k: _cost(tiles, steps, k, held) for k, held in clusters.items()
             if held >= 1}
    assert _cost(tiles, steps, s, clusters[s]) == min(costs.values())
    # the smallest S among the cheapest: the shortest sum
    assert s == min(k for k, c in costs.items() if c == min(costs.values()))


def test_plan_at_the_policy_convs_on_an_h100():
    """36 and 18 tiles of 15,625 steps on the H100's table: `final` in one
    wave of 36 clusters of 3 (108 of 132 SMs), `up0` in three waves of 7
    clusters of 16; waves × steps a CTA within 25 % and 40 % of an even share
    of the steps over 132 SMs (clusters must each fit in one GPC)."""
    for ci, cluster, waves, slack in ((256, 3, 1, 1.25), (128, 16, 3, 1.40)):
        plan = C.dw_resident_plan(100 ** 3, ci, 128, H100)
        assert (plan["cluster"], plan["waves"]) == (cluster, waves), plan
        even = C.dw_tiles(ci, 128) * C.dw_steps(100 ** 3) / 132
        assert plan["waves"] * plan["steps_per_cta"] <= slack * even, plan


def test_plan_skips_sizes_the_card_cannot_hold_and_raises_without_any():
    table = {s: 0 for s in range(1, C.DW_MAX_CLUSTER + 1)}
    table[3] = 5
    assert C.dw_resident_plan(100 ** 3, 256, 128, table)["cluster"] == 3
    table[17] = 99          # above the kernel's limit: not a candidate
    assert C.dw_resident_plan(100 ** 3, 256, 128, table)["cluster"] == 3
    with pytest.raises(RuntimeError, match="no cluster size"):
        C.dw_resident_plan(100 ** 3, 256, 128, {s: 0 for s in range(1, 17)})


@pytest.mark.parametrize("cluster", range(1, C.DW_MAX_CLUSTER + 1))
def test_rank_shares_cover_each_tile_once(cluster):
    shares = C.dw_rank_shares(cluster)
    assert len(shares) == cluster
    covered = np.zeros(C.DW_TILE_F4, np.int64)
    for lo, hi in shares:
        assert 0 <= lo <= hi <= C.DW_TILE_F4
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # contiguous, in rank order
    assert all(shares[r][1] == shares[r + 1][0] or shares[r + 1][0] == shares[r + 1][1]
               for r in range(cluster - 1))


@pytest.mark.parametrize("steps,cluster", [(15625, 1), (15625, 7), (15625, 16),
                                           (15625, 12), (33, 16), (16, 16),
                                           (17, 16), (1, 16), (1, 1), (3, 8),
                                           (4, 3)])
def test_rank_steps_give_every_step_to_one_rank(steps, cluster):
    """Also with fewer steps than ranks: the late ranks get none (they still
    write zeros and meet both cluster barriers in the kernel)."""
    slices = C.dw_rank_steps(steps, cluster)
    assert len(slices) == cluster
    owner = np.zeros(steps, np.int64)
    for lo, hi in slices:
        assert 0 <= lo <= hi <= steps
        owner[lo:hi] += 1
    assert (owner == 1).all()
    per = -(-steps // cluster)
    assert all(hi - lo <= per for lo, hi in slices)
    if steps < cluster:
        assert sum(hi > lo for lo, hi in slices) == steps


def _kernel_model(x, dy, cluster):
    """dW as the resident kernel computes it, in plain tensor code: each
    rank's partial over its steps' voxels (the plain version with dy zero
    outside them), laid out per tile as [3 x taps][64 ci][128 co] and cut
    into float4; each rank adds its share over the ranks in rank order and
    writes it through the kernel's float4 → (tap, row, col) map."""
    b, d, h, w, ci = x.shape
    co = dy.shape[-1]
    voxels = b * d * h * w
    flat = dy.reshape(voxels, co)
    parts = []
    for lo, hi in C.dw_rank_steps(C.dw_steps(voxels), cluster):
        keep = torch.zeros(voxels, 1)
        keep[lo * C.VOXELS_PER_STEP:hi * C.VOXELS_PER_STEP] = 1.0
        parts.append(C.conv3d_dw_reference(x, (flat * keep).reshape(dy.shape)))
    ci_t, co_t = -(-ci // C.DW_TILE_CI), -(-co // C.DW_TILE_CO)
    padded = [torch.zeros(27, ci_t * C.DW_TILE_CI, co_t * C.DW_TILE_CO)
              for _ in parts]
    for p, q in zip(padded, parts):
        p[:, :ci, :co] = q
    dw = torch.full((27, ci, co), float("nan"))
    i = torch.arange(C.DW_TILE_F4)
    ox = i // (C.DW_TILE_CI * C.DW_TILE_CO // 4)
    row = (i // (C.DW_TILE_CO // 4)) % C.DW_TILE_CI
    col = (i % (C.DW_TILE_CO // 4)) * 4
    for tile in range(C.dw_tiles(ci, co)):
        zy, c0 = tile // (co_t * ci_t), ((tile // co_t) % ci_t) * C.DW_TILE_CI
        n0 = (tile % co_t) * C.DW_TILE_CO
        # the tile's [3][64][128] partial of each rank, as float4 rows
        lay = [p[zy * 3:zy * 3 + 3, c0:c0 + C.DW_TILE_CI,
                 n0:n0 + C.DW_TILE_CO].reshape(C.DW_TILE_F4, 4) for p in padded]
        for lo, hi in C.dw_rank_shares(cluster):
            s = lay[0][lo:hi].clone()
            for r in range(1, cluster):
                s += lay[r][lo:hi]
            for k in range(lo, hi):
                t, rr, cc = zy * 3 + int(ox[k]), c0 + int(row[k]), n0 + int(col[k])
                if rr < ci and cc < co:
                    dw[t, rr, cc:cc + 4] = s[k - lo]
    return dw


@pytest.mark.parametrize("shape,cluster", [((1, 3, 3, 3, 64, 128), 16),
                                           ((1, 5, 6, 7, 8, 16), 3),
                                           ((1, 12, 13, 14, 72, 136), 7),
                                           ((2, 4, 5, 6, 24, 40), 12)])
def test_rank_order_sum_of_partials_equals_the_plain_dw(shape, cluster):
    """Every dW element written once (no NaN left), and the rank-order sum
    within float32 rounding of the plain version's one sum."""
    b, d, h, w, ci, co = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, d, h, w, ci)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, d, h, w, co)).astype(np.float32))
    got = _kernel_model(x, dy, cluster)
    ref = C.conv3d_dw_reference(x, dy)
    assert not torch.isnan(got).any()
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 1e-5 * scale
