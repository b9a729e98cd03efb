"""The CUDA 3³ conv kernels (forward/dx, dW by the workspace and the resident
scheme) against their plain PyTorch versions, on the card; the resident
scheme also at every kind of cluster size (more CTAs than steps among them),
at the widest cluster the card holds and at the plan it picks, and the
card's table of co-resident clusters it plans from; the policy's two 100³
convolutions in bf16.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_conv_gpu.py -m gpu

Tolerances, relative to max(1, max|plain|). float32 (plain FMA against a
float32 matmul, other summation order): 1e-5. bfloat16: both sides multiply
the same bf16 values exactly and differ only in the order and the rounding of
the float32 accumulation (the tensor cores do not round to nearest), over
27·Ci terms in the forward (1e-3) and over every voxel in dW (2^-8, one bf16
step: what dW is rounded to before it reaches the parameter).
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops.conv3d import (DW_MAX_CLUSTER, conv3d_dw,
                                               conv3d_dw_reference,
                                               conv3d_dw_resident,
                                               conv3d_dw_resident_cluster,
                                               conv3d_dw_workspace,
                                               conv3d_forward,
                                               conv3d_same_batched,
                                               conv3d_same_reference,
                                               dw_resident_plan,
                                               resident_clusters)

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -8)}

# (B, D, H, W, Ci, Co): ragged volumes that divide by no tile, one voxel row
# shorter than a tile, channel counts under and over a tile; a batch of 2
# whose voxel tiles straddle the samples at full 128-channel tiles; 128 ↔ 256
# channels (a forward and a dx over two 128-wide tiles of output channels);
# 27 voxels, one step of the dW walk
SHAPES = [(1, 5, 6, 7, 8, 16), (2, 9, 10, 11, 24, 40), (1, 12, 13, 14, 72, 136),
          (1, 3, 2, 1, 16, 8), (2, 12, 13, 14, 128, 128), (1, 6, 7, 9, 128, 256),
          (1, 6, 7, 9, 256, 128), (1, 3, 3, 3, 64, 128)]


def _inputs(shape, dtype, seed=0):
    b, d, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x = mk(b, d, h, w, ci).cuda().to(dtype)
    wm = (0.1 * mk(27, ci, co)).cuda().to(dtype)
    dy = mk(b, d, h, w, co).cuda().to(dtype)
    return x, wm, dy


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / max(1.0, b.abs().max().item())).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_conv_kernels_match_plain_versions(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    x, wm, dy = _inputs(shape, dtype)
    ftol, wtol = TOL[dtype]
    n0 = conv3d_forward.launches
    y = conv3d_forward(x, wm)
    torch.cuda.synchronize()
    assert conv3d_forward.launches == n0 + 1
    assert y.dtype == torch.float32
    assert _rel(y, conv3d_same_reference(x, wm)) <= ftol
    # dx: the same kernel on dy with the taps flipped and Ci/Co swapped
    w_flip = wm.flip(0).transpose(1, 2).contiguous()
    assert _rel(conv3d_forward(dy, w_flip),
                conv3d_same_reference(dy, w_flip)) <= ftol
    ref = conv3d_dw_reference(x, dy)
    for entry in (conv3d_dw_workspace, conv3d_dw_resident):
        before = entry.launches
        got = entry(x, dy)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert _rel(got, ref) <= wtol, entry.__name__
        # deterministic: no atomics, the same bits on a second run
        assert torch.equal(entry(x, dy), got), entry.__name__
    # kernel against kernel: two independent sums, each within wtol of the
    # plain version
    assert _rel(conv3d_dw_workspace(x, dy), conv3d_dw_resident(x, dy)) <= 2 * wtol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_conv_autograd_follows_the_cpu_function(dtype):
    """`conv3d_same_batched` on the card against the same Function on the CPU
    (the plain versions): y float32, dx in x's dtype, dW in w's dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    shape = (2, 6, 7, 9, 16, 24)
    x, wm, dy = _inputs(shape, dtype, seed=1)
    outs = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_()
        wd = wm.reshape(3, 3, 3, 16, 24).to(dev).requires_grad_()
        y = conv3d_same_batched(xd, wd)
        gx, gw = torch.autograd.grad(y, (xd, wd), dy.float().to(dev))
        assert y.dtype == torch.float32 and gx.dtype == dtype and gw.dtype == dtype
        outs[dev] = [t.detach().float().cpu() for t in (y, gx, gw)]
    ftol, wtol = TOL[dtype]
    step = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0   # a rounding flip
    for got, ref, tol in zip(outs["cuda"], outs["cpu"],
                             (ftol, ftol + step, wtol + step)):
        assert _rel(got, ref) <= tol


@pytest.mark.gpu
def test_cuda_conv_wrapper_refuses_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    x, wm, dy = _inputs((1, 4, 4, 4, 12, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3d_forward(x, wm)                       # Ci = 12 in bf16
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3d_dw(x, dy)
    with pytest.raises(ValueError):
        conv3d_forward(x.double(), wm.double())
    with pytest.raises(ValueError):
        conv3d_forward(x.float(), wm)               # mixed dtypes
    with pytest.raises(ValueError, match="scheme"):
        conv3d_dw(x, dy, scheme="atomic")


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 9, DW_MAX_CLUSTER])
@pytest.mark.parametrize("shape", [(1, 3, 3, 3, 64, 128), (1, 5, 6, 7, 8, 16),
                                   (2, 12, 13, 14, 128, 128)])
def test_cuda_resident_dw_at_every_cluster_size(shape, cluster):
    """The resident kernel at a given cluster size, also where the cluster
    has more CTAs than the walk has steps (27 and 210 voxels: 1 and 4 steps;
    those CTAs write zeros and meet both cluster barriers): within tol of
    the plain version, within 2·tol of the workspace scheme, the same bits
    on a second run, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    if resident_clusters(torch.device("cuda"))[cluster] < 1:
        pytest.skip(f"this card holds no cluster of {cluster} resident CTAs")
    x, _, dy = _inputs(shape, torch.bfloat16, seed=2)
    _, wtol = TOL[torch.bfloat16]
    before = conv3d_dw_resident.launches
    got = conv3d_dw_resident_cluster(x, dy, cluster)
    torch.cuda.synchronize()
    assert conv3d_dw_resident.launches == before + 1
    assert _rel(got, conv3d_dw_reference(x, dy)) <= wtol
    assert _rel(got, conv3d_dw_workspace(x, dy)) <= 2 * wtol
    assert torch.equal(conv3d_dw_resident_cluster(x, dy, cluster), got)


@pytest.mark.gpu
def test_cuda_resident_cluster_table_and_refused_sizes():
    """The occupancy table the plan reads: every size 1 .. DW_MAX_CLUSTER,
    one CTA an SM (clusters of 1 fill the card), never more CTAs than SMs,
    fewer clusters as they grow. A size the kernel does not take raises;
    nothing retries with another size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    table = resident_clusters(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sorted(table) == list(range(1, DW_MAX_CLUSTER + 1))
    assert table[1] == sms
    assert all(table[s] * s <= sms for s in table)
    assert all(table[s + 1] <= table[s] for s in range(1, DW_MAX_CLUSTER))
    x, _, dy = _inputs((1, 4, 4, 4, 16, 16), torch.bfloat16)
    before = conv3d_dw_resident.launches
    for bad in (0, DW_MAX_CLUSTER + 1):
        with pytest.raises(RuntimeError, match="launch failed"):
            conv3d_dw_resident_cluster(x, dy, bad)
    with pytest.raises(ValueError, match="bf16 kernel"):
        conv3d_dw_resident_cluster(x.float(), dy.float(), 2)
    assert conv3d_dw_resident.launches == before


def _check_dw_schemes(x, dy, wtol):
    """dW by the workspace scheme, the resident scheme at its plan and at
    the widest cluster the card holds: each within wtol of the plain
    version and 2·wtol of the workspace scheme, each the same bits on a
    second run; the resident entry point launches the plan's cluster (the
    same bits as that size forced)."""
    table = resident_clusters(torch.device("cuda"))
    widest = max(s for s, held in table.items() if held > 0)
    b, d, h, w, ci = x.shape
    plan = dw_resident_plan(b * d * h * w, ci, dy.shape[-1], table)
    assert 1 <= plan["cluster"] <= DW_MAX_CLUSTER
    assert plan["clusters_at_once"] == table[plan["cluster"]] >= 1
    ref = conv3d_dw_reference(x, dy)
    got = {}
    for name, fn in (("workspace", conv3d_dw_workspace),
                     ("resident", conv3d_dw_resident),
                     ("widest", lambda x, dy: conv3d_dw_resident_cluster(
                         x, dy, widest))):
        got[name] = fn(x, dy)
        assert _rel(got[name], ref) <= wtol, name
        assert torch.equal(fn(x, dy), got[name]), name
        assert _rel(got["workspace"], got[name]) <= 2 * wtol, name
    assert torch.equal(conv3d_dw_resident_cluster(x, dy, plan["cluster"]),
                       got["resident"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_resident_dw_at_the_widest_cluster_and_at_its_plan(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    x, _, dy = _inputs(shape, torch.bfloat16, seed=3)
    _check_dw_schemes(x, dy, TOL[torch.bfloat16][1])


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co", [(256, 128),    # `final`
                                   (128, 128)])   # `up0` after the resize
def test_cuda_conv_kernels_at_the_policys_100_cubed_convs(ci, co):
    """The policy's two full-resolution convolutions in bf16, [1, 100, 100,
    100, Ci] → Co: the forward and dx against the plain versions, and dW as
    `_check_dw_schemes`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    gen = torch.Generator(device="cuda").manual_seed(2)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = mk(1, 100, 100, 100, ci).to(torch.bfloat16)
    wm = (0.05 * mk(27, ci, co)).to(torch.bfloat16)
    dy = mk(1, 100, 100, 100, co).to(torch.bfloat16)
    ftol, wtol = TOL[torch.bfloat16]
    assert _rel(conv3d_forward(x, wm), conv3d_same_reference(x, wm)) <= ftol
    w_flip = wm.flip(0).transpose(1, 2).contiguous()
    assert _rel(conv3d_forward(dy, w_flip),
                conv3d_same_reference(dy, w_flip)) <= ftol
    _check_dw_schemes(x, dy, wtol)
