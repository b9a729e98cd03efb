"""The multi-tensor LAMB's host side, on the CPU.

The work table that `ops/fused_lamb` builds for the kernel (`csrc/lamb.cu`)
covers every element of every leaf exactly once, in leaf order, across
ragged last chunks, leaves of one element and leaves of none; the launch
groups partition the leaves in order; the wrapper raises on what the kernel
does not take (a CPU tensor where a CUDA one is wanted, another dtype, a
non-contiguous tensor, another shape) and never falls back; and `Lamb.step`
on CPU leaves is, bit for bit, the loop it ran before the kernel existed.
The kernel itself runs only on the card (tests/test_torch_lamb_gpu.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch import config as C
from manigaussian_tpu_torch.agents.qfunction import QFunction
from manigaussian_tpu_torch.ops.fused_lamb import (CHUNK, LEAVES_PER_LAUNCH,
                                                   FusedLamb, check_leaf,
                                                   launch_groups, leaf_spans,
                                                   work_items)
from manigaussian_tpu_torch.utils.optimizers import (Lamb,
                                                     clip_by_global_norm_)


def gnf_micro_numels():
    """GNFACTOR_BC's leaves at the micro width, in the optimizer's order."""
    cfg = C.micro_variant("w_geo")
    with torch.device("meta"):
        q = QFunction(dataclasses.replace(cfg.method, name="GNFACTOR_BC"))
    return [p.numel() for p in q.parameters()]


NUMELS = {
    "one_element": [1],
    "ones": [1, 1, 1],
    "whole_chunks": [CHUNK, 2 * CHUNK],
    "ragged": [CHUNK + 1, 1, 3 * CHUNK - 5, 7, CHUNK - 1],
    "a_leaf_of_none": [5, 0, CHUNK + 3, 0],
}


def assert_exact_cover(numels, chunk):
    items = work_items(numels, chunk)
    assert items.dtype == np.int64 and items.shape == (len(items), 3)
    # leaf order, each leaf's rows together
    assert (np.diff(items[:, 0]) >= 0).all()
    first, count = leaf_spans(items, len(numels))
    assert first[0] == 0 and count.sum() == len(items)
    for leaf, n in enumerate(numels):
        rows = items[first[leaf]:first[leaf] + count[leaf]]
        assert (rows[:, 0] == leaf).all()
        # the starts step by `chunk` from 0 and each length runs to the
        # next start or to the leaf's end: every element once
        np.testing.assert_array_equal(rows[:, 1], np.arange(0, n, chunk))
        np.testing.assert_array_equal(rows[:, 2],
                                      np.minimum(chunk, n - rows[:, 1]))
        assert (rows[:, 2] >= 1).all()
    return items


@pytest.mark.parametrize("chunk", [CHUNK, 4])
@pytest.mark.parametrize("case", sorted(NUMELS))
def test_work_items_cover_every_element_once_in_leaf_order(case, chunk):
    numels = NUMELS[case]
    items = assert_exact_cover(numels, chunk)
    # the same, element by element
    hits = [np.zeros(n, np.int64) for n in numels]
    for leaf, start, length in items:
        hits[leaf][start:start + length] += 1
    assert all((h == 1).all() for h in hits)


def test_work_items_cover_gnfactor_bc_micro_leaves():
    numels = gnf_micro_numels()
    items = assert_exact_cover(numels, CHUNK)
    assert len(items) == sum(-(-n // CHUNK) for n in numels)
    assert items[:, 2].sum() == sum(numels)


@pytest.mark.parametrize("n", [1, LEAVES_PER_LAUNCH - 1, LEAVES_PER_LAUNCH,
                               LEAVES_PER_LAUNCH + 1, 3 * LEAVES_PER_LAUNCH + 7])
def test_launch_groups_partition_the_leaves_in_order(n):
    groups = launch_groups(n)
    assert groups[0][0] == 0 and groups[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(0 < hi - lo <= LEAVES_PER_LAUNCH for lo, hi in groups)


CUDA0 = torch.device("cuda", 0)


def test_check_leaf_takes_a_contiguous_float32_tensor_on_its_device():
    check_leaf("p", torch.zeros(4, 3), torch.device("cpu"), torch.Size([4, 3]))


def test_check_leaf_raises_on_a_cpu_tensor_where_cuda_is_wanted():
    with pytest.raises(ValueError, match="on cuda:0; g is a .* on cpu"):
        check_leaf("g", torch.zeros(3), CUDA0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
def test_check_leaf_raises_on_another_dtype(dtype):
    with pytest.raises(ValueError, match="float32"):
        check_leaf("p", torch.zeros(3, dtype=dtype), torch.device("cpu"))


def test_check_leaf_raises_on_a_non_contiguous_tensor():
    with pytest.raises(ValueError, match="non-contiguous"):
        check_leaf("p", torch.zeros(4, 3).t(), torch.device("cpu"))


def test_check_leaf_raises_on_another_shape():
    with pytest.raises(ValueError, match=r"\(4, 3\)"):
        check_leaf("m", torch.zeros(12), torch.device("cpu"), torch.Size([4, 3]))


def test_the_wrapper_takes_no_cpu_leaves():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        FusedLamb(p, [torch.zeros(3)], [torch.zeros(3)])
    with pytest.raises(ValueError, match="one moment pair a leaf"):
        FusedLamb(p, [], [])


def loop_before_the_kernel(opt, grads):
    """`Lamb.step`'s body as it was before the kernel, for CPU leaves."""
    norm = None
    if opt.grad_clip_norm > 0:
        norm = clip_by_global_norm_(grads, opt.grad_clip_norm)
    lr = opt.current_lr()
    b1, b2 = opt.b1, opt.b2
    for p, g, m, v in zip(opt.params, grads, opt.mu, opt.nu):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = m / (torch.sqrt(v) + opt.eps)
        if opt.weight_decay != 0.0:
            step = step + opt.weight_decay * p
        w_norm = torch.clamp(torch.linalg.norm(p.reshape(-1)), 0.0, 10.0)
        a_norm = torch.linalg.norm(step.reshape(-1))
        trust = torch.where((w_norm == 0.0) | (a_norm == 0.0),
                            torch.ones_like(w_norm),
                            w_norm / torch.clamp(a_norm, min=1e-30))
        p.add_((-lr * trust) * step)
    opt.count += 1
    return norm


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-6])
def test_lamb_step_on_cpu_is_the_loop_bit_for_bit(weight_decay, clip):
    rng = np.random.default_rng(7)
    values = [0.05 * rng.standard_normal((64, 32)),     # a weight
              np.zeros(40),                              # a zero leaf
              np.full(CHUNK + 3, 0.5),                   # ‖p‖ over 10
              rng.standard_normal(1),                    # one element
              0.1 * rng.standard_normal(9)]              # no gradient
    make = lambda: [torch.tensor(v, dtype=torch.float32) for v in values]
    lr = lambda count: 5e-4 * (1 + count)
    opt = Lamb(make(), lr, weight_decay=weight_decay, grad_clip_norm=clip)
    ref = Lamb(make(), lr, weight_decay=weight_decay, grad_clip_norm=clip)
    for _ in range(3):
        grads = [torch.tensor(1e-2 * rng.standard_normal(v.shape),
                              dtype=torch.float32) for v in values[:-1]]
        for p, g in zip(opt.params, grads):
            p.grad = g.clone()
        norm = opt.step()
        want = loop_before_the_kernel(
            ref, [g.clone() for g in grads] + [torch.zeros(9)])
        assert (norm is None) == (want is None)
        if norm is not None:
            assert torch.equal(norm, want)
        for a, b in zip(opt.params + opt.mu + opt.nu,
                        ref.params + ref.mu + ref.nu):
            assert torch.equal(a, b)
        assert opt.count == ref.count
