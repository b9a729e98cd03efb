"""The port's multi-device layer on the CPU (gloo, one process a rank): the
mesh and its groups, the collectives, the two autograd functions of the tile
group, the flash kernels' dropout hash on one rank's rows (`bh_offset`), and
the batch helpers.

Ranks run in processes of their own (tests/torch_parallel_workers.py), each
start joined with its own timeout, so a hang fails the test. Exact checks
throughout: gathers and replicated gradients are sums with zeros or small
integers, the masks bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.flash_attention import _dropout_mask
from manigaussian_tpu_torch.ops.flash_attention import (
    dropout_keep_bits, dropout_keep_mask, dropout_row_part,
    flash_self_attention)
from manigaussian_tpu_torch.parallel.distributed import (Rows,
                                                         disjoint_replay,
                                                         global_batch,
                                                         global_draw,
                                                         local_batch_to_global,
                                                         parse_spec)
from tests.torch_parallel_workers import mesh_worker, run_ranks


@pytest.mark.parametrize("shape,axes,groups", [
    ((2,), ("data",), {"data": [[0, 1]]}),
    ((2, 2), ("data", "tile"), {"data": [[0, 2], [1, 3]],
                                "tile": [[0, 1], [2, 3]]}),
])
def test_mesh_groups_collectives_and_autograd(tmp_path, shape, axes, groups):
    world = int(np.prod(shape))
    run_ranks(mesh_worker, world, (shape, axes, str(tmp_path)), timeout=120)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for rank, r in enumerate(res):
        want = dict(zip(axes, np.unravel_index(rank, shape)))
        assert r["coords"] == {a: int(c) for a, c in want.items()}
        assert r["shape"] == dict(zip(axes, shape))
        for a in axes:
            members = next(g for g in groups[a] if rank in g)
            assert r["groups"][a] == members
            n, i = r[f"{a}/size_index"]
            assert (n, i) == (len(members), members.index(rank))
            # gather: every member's rows in group order, bit for bit
            want_rows = torch.cat([res[m][f"{a}/mine"] for m in members])
            assert torch.equal(r[f"{a}/gathered"], want_rows)
            vals = torch.stack([torch.tensor([float(m), -2.0 * m, 1.0])
                                for m in members])
            red = r[f"{a}/reduced"]
            assert torch.equal(red["sum"], vals.sum(0))
            assert torch.equal(red["mean"], vals.sum(0) / len(members))
            assert torch.equal(red["min"], vals.min(0).values)
            assert torch.equal(red["max"], vals.max(0).values)
            # replicate: identity forward; gradient summed over the group
            same, gx, gy = r[f"{a}/replicate"]
            assert same
            assert torch.equal(gx, torch.full((2, 3), float(
                sum(m + 1 for m in members))))
            assert torch.equal(gy, 2 * torch.arange(4.0) * sum(members))
            # gather_patches: the rank's own rows of the gradient; anchor 0
            full, _, gp, ganchor, w_rows = r[f"{a}/patches"]
            assert torch.equal(full, torch.cat(
                [res[m][f"{a}/patches"][1] for m in members]))
            assert torch.equal(gp, w_rows)
            assert torch.equal(ganchor, torch.zeros(3))
        assert r["in_sync_same"] and not r["in_sync_differ"]


def test_spec_batch_rows_and_global_draws():
    assert parse_spec("localhost:29500,4,3") == ("localhost", 29500, 4, 3)
    with pytest.raises(ValueError):
        parse_spec("h:1,2,2")

    class FakeMesh:
        def __init__(self, i, n):
            self.i, self.n = i, n

        def size(self, axis):
            return self.n

        def index(self, axis):
            return self.i

    batch = {"x": np.arange(12).reshape(6, 2), "s": ["a", "b", "c", "d", "e", "f"]}
    parts = [global_batch(batch, FakeMesh(i, 3)) for i in range(3)]
    assert np.array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert sum((p["s"] for p in parts), []) == batch["s"]
    with pytest.raises(ValueError):
        global_batch(batch, FakeMesh(0, 4))
    assert local_batch_to_global(parts[1], FakeMesh(1, 3), 6) is parts[1]
    replay = disjoint_replay(FakeMesh(1, 3))
    for i in range(7):
        replay.add("t", {"i": np.array(i)})
    assert replay._indices("t") == [1, 4]
    with pytest.raises(ValueError):
        local_batch_to_global(parts[1], FakeMesh(1, 3), 8)
    # a draw for the rank's rows is the global draw's rows, and the
    # generator ends where the one-process draw leaves it
    draw = lambda g: (lambda n: torch.rand(n, 3, generator=g))
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    whole = global_draw(draw(g1), 4, None)
    rows = global_draw(draw(g2), 2, Rows(2, 4))
    assert torch.equal(rows, whole[2:])
    assert torch.equal(torch.rand(1, generator=g1), torch.rand(1, generator=g2))


@pytest.mark.parametrize("rate,block_q", [(0.1, 256), (0.5, 128)])
def test_flash_mask_at_bh_offset_is_the_global_masks_rows(rate, block_q):
    """One rank's mask (heads bh_offset …) equals the matching rows of the
    whole batch's, and the TPU kernel's `_dropout_mask` of those global
    heads; the row part, the keep bits and the plain forward likewise."""
    seed, n, heads, lo, b = 2 ** 31 - 5, 256, 4, 1, 2
    whole = dropout_keep_mask(seed, rate, 4 * heads, n, block_q)
    part = dropout_keep_mask(seed, rate, b * heads, n, block_q,
                             bh_offset=lo * heads)
    assert torch.equal(part, whole[lo * heads:(lo + b) * heads])
    assert torch.equal(
        dropout_row_part(seed, b * heads, n, block_q, bh_offset=lo * heads),
        dropout_row_part(seed, 4 * heads, n, block_q)[lo * heads:(lo + b) * heads])
    assert torch.equal(
        dropout_keep_bits(seed, rate, b * heads, n, block_q,
                          bh_offset=lo * heads),
        dropout_keep_bits(seed, rate, 4 * heads, n, block_q)[lo * heads:(lo + b) * heads])
    seed_ref = jnp.array([seed], jnp.int32)
    for h in range(b * heads):
        for i in range(n // block_q):
            ref = np.asarray(_dropout_mask(seed_ref, lo * heads + h, i,
                                           (block_q, n), rate))
            np.testing.assert_array_equal(
                part[h, i * block_q:(i + 1) * block_q].numpy(), ref > 0.5)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, heads, n, 16, generator=g) for _ in range(3))
    out_w = flash_self_attention(q, k, v, rate, torch.tensor([seed]), block_q)
    out_p = flash_self_attention(q[lo:lo + b], k[lo:lo + b], v[lo:lo + b],
                                 rate, torch.tensor([seed]), block_q,
                                 bh_offset=lo * heads)
    assert torch.equal(out_p, out_w[lo:lo + b])
