"""The port's 3³ conv (`ops/conv3d.py`, the plain versions that CPU tensors
take) against the JAX package's Pallas conv run in interpret mode, as
tests/test_pallas_conv.py runs it on the CPU.

Inputs come from a numpy seed and go to both. Tolerances: float32 forward
rtol/atol 1e-5, gradients 1e-4 (other summation orders). bfloat16: both sides
multiply the same bf16 values exactly and accumulate in float32, then round
where the JAX custom VJP rounds (y float32, dx to bf16, dW to bf16), so an
element may differ by one bf16 step where its float32 sum sits on a rounding
boundary: 2^-8 of the power of two above it, so at most 2^-7 of the element
(plus 1e-5 of the tensor's scale for elements near zero).

The weight gradient is also held to the two other accumulation schemes of
scripts/r4_pallas_dw_repro.py (`_dw_kernel_stacked`, `_dw_kernel_scratch`):
their `pl.pallas_call`s are built here as the script's `run_case` builds them,
but with interpret=True (the script compiles for a TPU only).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from manigaussian_tpu.models.blocks import Conv3DBlock as JBlock
from manigaussian_tpu.ops import pallas_conv as pc
from manigaussian_tpu_torch.models.blocks import Conv3DBlock as TBlock
from manigaussian_tpu_torch.ops.conv3d import (conv3d_dw, conv3d_dw_reference,
                                               conv3d_same,
                                               conv3d_same_batched,
                                               conv3d_same_reference)

BF16_STEP = 2.0 ** -7
SHAPES = [(8, 8, 8, 8, 16), (10, 10, 10, 16, 8)]


def _np_inputs(d, h, w, ci, co, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = rng.standard_normal(lead + (d, h, w, ci)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, 3, ci, co))).astype(np.float32)
    g = rng.standard_normal(lead + (d, h, w, co)).astype(np.float32)
    return x, k, g


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_a_bf16_step(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_STEP,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("d,h,w,ci,co", SHAPES)
def test_forward_matches_jax(d, h, w, ci, co):
    x, k, _ = _np_inputs(d, h, w, ci, co)
    want = _f32(pc.conv3d_same(jnp.asarray(x), jnp.asarray(k)))
    got = conv3d_same(_t(x), _t(k))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,h,w,ci,co", SHAPES)
def test_gradients_match_jax(d, h, w, ci, co):
    x, k, g = _np_inputs(d, h, w, ci, co, seed=1)
    jg = jnp.asarray(g)
    gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(pc.conv3d_same(a, b) * jg),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx, tk = _t(x).requires_grad_(), _t(k).requires_grad_()
    gx, gw = torch.autograd.grad(conv3d_same(tx, tk), (tx, tk), _t(g))
    np.testing.assert_allclose(gx.numpy(), _f32(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), _f32(gw_j), rtol=1e-4, atol=1e-4)


def test_bfloat16_dtype_flow_matches_jax():
    """y float32; dx and dW rounded to bf16, each within one bf16 step."""
    x, k, g = _np_inputs(8, 8, 8, 16, 16, seed=2)
    jx, jk = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    jy, vjp = jax.vjp(pc.conv3d_same, jx, jk)
    gx_j, gw_j = vjp(jnp.asarray(g))
    assert (jy.dtype, gx_j.dtype, gw_j.dtype) == (
        jnp.float32, jnp.bfloat16, jnp.bfloat16)
    tx = _t(x, torch.bfloat16).requires_grad_()
    tk = _t(k, torch.bfloat16).requires_grad_()
    y = conv3d_same(tx, tk)
    gx, gw = torch.autograd.grad(y, (tx, tk), _t(g))
    assert (y.dtype, gx.dtype, gw.dtype) == (
        torch.float32, torch.bfloat16, torch.bfloat16)
    # the same exact products, float32 sums in another order
    np.testing.assert_allclose(y.detach().numpy(), _f32(jy), rtol=1e-5, atol=1e-5)
    for got, want in ((gx, gx_j), (gw, gw_j)):
        _within_a_bf16_step(got.float().numpy(), _f32(want))


def test_batched_matches_jax():
    x, k, g = _np_inputs(6, 7, 8, 8, 8, seed=3, batch=2)
    jg = jnp.asarray(g)
    want = _f32(pc.conv3d_same_batched(jnp.asarray(x), jnp.asarray(k)))
    gw_j = jax.grad(lambda b: jnp.sum(
        pc.conv3d_same_batched(jnp.asarray(x), b) * jg))(jnp.asarray(k))
    tk = _t(k).requires_grad_()
    y = conv3d_same_batched(_t(x), tk)
    (gw,) = torch.autograd.grad(y, tk, _t(g))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), _f32(gw_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3dblock_pallas_matches_the_jax_block(dtype):
    """Conv3DBlock(impl='pallas'): bias and lrelu in float32 outside the
    kernel, output in `dtype`; the parameters' gradients in float32, the
    kernel's rounded to `dtype` on the way."""
    ci, co = 16, 24
    x, k, g = _np_inputs(6, 6, 7, ci, co, seed=4, batch=2)
    bias = (0.1 * np.random.default_rng(5).standard_normal(co)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblock = JBlock(co, 3, 1, "lrelu", dtype=jdt, pad_mode="zero", impl="pallas")
    params = {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}}
    jg = jnp.asarray(g)

    def jloss(p):
        return jnp.sum(jblock.apply(p, jnp.asarray(x)).astype(jnp.float32) * jg)

    jy = jblock.apply(params, jnp.asarray(x))
    jgrad = jax.grad(jloss)(params)["params"]

    tblock = TBlock(ci, co, 3, 1, "lrelu", dtype=tdt, pad_mode="zero",
                    impl="pallas")
    with torch.no_grad():
        tblock.weight.copy_(_t(k).permute(4, 3, 0, 1, 2))
        tblock.bias.copy_(_t(bias))
    ty = tblock(_t(x))
    (ty.float() * _t(g)).sum().backward()
    assert ty.dtype == tdt and tblock.weight.grad.dtype == torch.float32
    pairs = ((ty.detach().float().numpy(), _f32(jy), 1e-5),
             (tblock.weight.grad.permute(2, 3, 4, 1, 0).numpy(),
              _f32(jgrad["kernel"]), 1e-4),
             (tblock.bias.grad.numpy(), _f32(jgrad["bias"]), 1e-4))
    for got, want, tol in pairs:
        if dtype == "float32":
            assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())
        else:
            _within_a_bf16_step(got, want)


def _repro_module():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "r4_pallas_dw_repro.py")
    spec = importlib.util.spec_from_file_location("r4_pallas_dw_repro", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _repro_dw(variant, x, dy):
    """The script's `run_case` for 'stacked' and 'scratch', interpreted."""
    mod = _repro_module()
    d, h, w_sp, ci = x.shape
    co = dy.shape[-1]
    bd, bh = pc._pick_tiles(d, h)
    wp = -(-(w_sp + 2) // 8) * 8
    xp = jnp.pad(x, ((1, 1), (1, 1), (1, wp - w_sp - 1), (0, 0)))
    dyp = jnp.pad(dy.astype(jnp.float32), ((0, 0), (0, 0), (0, wp - w_sp), (0, 0)))
    grid = (d // bd, h // bh)
    common = dict(
        grid=grid,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((bd, bh, wp, co), lambda i, j: (i, j, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((27, ci, co), lambda i, j: (0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((27, ci, co), jnp.float32),
        interpret=True)
    xbuf = pltpu.VMEM((bd + 2, bh + 2, wp, ci), x.dtype)
    if variant == "stacked":
        kern = functools.partial(mod._dw_kernel_stacked, bd=bd, bh=bh, wp=wp,
                                 ci=ci, co=co)
        scratch = [xbuf, pltpu.SemaphoreType.DMA(())]
    else:
        kern = functools.partial(mod._dw_kernel_scratch, bd=bd, bh=bh, wp=wp,
                                 ci=ci, co=co, gi=grid[0], gj=grid[1])
        scratch = [xbuf, pltpu.VMEM((27, ci, co), jnp.float32),
                   pltpu.SemaphoreType.DMA(())]
    return pl.pallas_call(kern, scratch_shapes=scratch, **common)(xp, dyp)


@pytest.mark.parametrize("variant", ["stacked", "scratch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_reference_matches_the_repro_script_variants(variant, dtype):
    x, _, g = _np_inputs(8, 8, 10, 16, 8, seed=6)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # the script feeds x in the compute dtype and dy in float32; the kernels
    # cast dy to x's dtype, so dy's values are rounded to it first here too
    jdy = jnp.asarray(g).astype(jdt)
    want = _f32(_repro_dw(variant, jnp.asarray(x, jdt), jdy))
    tdy = _t(_f32(jdy), tdt)
    tx = _t(x, tdt)[None]
    for got in (conv3d_dw_reference(tx, tdy[None]),
                conv3d_dw(tx, tdy[None], scheme="resident")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_versions_agree_with_a_library_convolution():
    """An independent check of the plain versions' tap order and padding."""
    import torch.nn.functional as F
    x, k, g = _np_inputs(5, 6, 7, 8, 12, seed=7, batch=2)
    tx, tk = _t(x).requires_grad_(), _t(k).requires_grad_()
    ref = F.conv3d(tx.permute(0, 4, 1, 2, 3), tk.permute(4, 3, 0, 1, 2),
                   padding=1).permute(0, 2, 3, 4, 1)
    (rw,) = torch.autograd.grad(ref, tk, _t(g))
    y = conv3d_same_reference(tx.detach(), tk.detach().reshape(27, 8, 12))
    dw = conv3d_dw_reference(tx.detach(), _t(g)).reshape(3, 3, 3, 8, 12)
    np.testing.assert_allclose(y.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), rw.numpy(), rtol=1e-4, atol=1e-4)
