"""The port's flash self-attention (manigaussian_tpu_torch/ops/flash_attention.py)
against the JAX Pallas kernels (interpret mode on the CPU).

On the CPU the wrapper runs its plain PyTorch version (and autograd of it),
so these cases hold that version to the TPU kernels' arithmetic: the
forward, the dropout mask (bit for bit: the same hash), and dq/dk/dv
against `jax.grad` of the TPU kernel's VJP. Tolerances are those of
tests/test_flash_attention.py: 1e-5 in fp32 (the same fp32 math in another
summation order), 2e-2 in bf16 (probabilities, output and dS are rounded to
bf16, whose step is 2^-8 relative), gradients relative to max(1, their
largest magnitude). The CUDA kernels themselves are held to the plain
version on the card by tests/test_torch_flash_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.flash_attention import _dropout_mask
from manigaussian_tpu.ops.flash_attention import \
    flash_self_attention as jax_flash
from manigaussian_tpu_torch.models.perceiver import flash_block_q
from manigaussian_tpu_torch.ops.flash_attention import (
    dropout_keep_mask, flash_self_attention, flash_self_attention_reference)
from tests.torch_port_helpers import assert_close


def _qkv(seed, b=1, h=4, n=128, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype,n,d,tol", [
    ("float32", 128, 32, 1e-5),
    ("float32", 128, 64, 1e-5),
    ("float32", 512, 32, 1e-5),    # two query blocks of 256
    ("float32", 512, 64, 1e-5),
    ("bfloat16", 256, 64, 2e-2),
])
def test_plain_version_matches_jax_kernel(dtype, n, d, tol):
    q, k, v = _qkv(0, n=n, d=d)
    bq = min(256, n)
    ref = jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)), block_q=bq)
    tdt = getattr(torch, dtype)
    out = flash_self_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               block_q=bq)
    assert out.dtype == tdt and out.shape == (1, 4, n, d)
    assert_close(out, np.asarray(ref, np.float32), tol)


def test_scale_is_rounded_in_the_input_dtype():
    """At d=32 the scale 32^-0.5 is not a bf16 value: q*scale must round the
    scale to bf16 first, as the TPU kernel does (torch's `q * float` would
    not, and moves 2-3 % of the scaled q values by one bf16 step). Large
    logits (q × 4) make the softmax sharp enough for that step to show; with
    the same rounding the outputs agree to about one bf16 step."""
    q, k, v = _qkv(1, n=128, d=32)
    q = q * 4
    ref = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    block_q=128)
    out = flash_self_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert_close(out, np.asarray(ref, np.float32), 8e-3)


def test_wrapper_contract():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, n=64))
    with pytest.raises(ValueError):
        flash_self_attention(q, k, v, block_q=48)
    with pytest.raises(ValueError):   # dropout needs a seed
        flash_self_attention(q, k, v, dropout_rate=0.1, block_q=64)
    before = flash_self_attention.launches
    flash_self_attention(q, k, v, block_q=64)
    flash_self_attention(q, k, v, dropout_rate=0.1,
                         dropout_seed=torch.tensor([3]), block_q=64)
    assert flash_self_attention.launches == before  # plain version: no launch


@pytest.mark.parametrize("rate,block_q", [(0.1, 256), (0.5, 128)])
def test_dropout_mask_is_the_tpu_kernels_bit_for_bit(rate, block_q):
    """The keep mask of every (head, query block) equals `_dropout_mask`."""
    bh, n, seed = 3, 512, 2 ** 31 - 2
    mask = dropout_keep_mask(seed, rate, bh, n, block_q).numpy()
    seed_ref = jnp.array([seed], jnp.int32)
    for h in range(bh):
        for i in range(n // block_q):
            ref = np.asarray(_dropout_mask(seed_ref, h, i, (block_q, n), rate))
            np.testing.assert_array_equal(
                mask[h, i * block_q:(i + 1) * block_q], ref > 0.5)
    assert abs(1.0 - mask.mean() - rate) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(256, 16), (256, 32), (512, 16), (512, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dropout_forward_and_gradients_match_jax(dtype, n, d, rate):
    q, k, v = _qkv(4, h=2, n=n, d=d)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    seed = 987654
    jdt = getattr(jnp, dtype)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, dropout_rate=rate,
                        dropout_seed=jnp.array([seed], jnp.int32), block_q=256)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = flash_self_attention(tq, tk, tv, dropout_rate=rate,
                               dropout_seed=torch.tensor([seed]), block_q=256)
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert_close(out, np.asarray(jout, np.float32), tol)
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        ref = np.asarray(j, np.float32)
        np.testing.assert_allclose(
            t.grad.float().numpy(), ref, rtol=0, err_msg="d" + name,
            atol=tol * max(1.0, float(np.abs(ref).max())))


def test_backward_delta_bound():
    """The CUDA backward uses delta_i = rowsum(dO ∘ O) with O the forward's
    bf16 output for the TPU kernel's Σ_j P_ij·dP_ij. The two differ only
    by the rounding of O and of the dropped P to bf16, each at most 2^-9
    relative:
      |Σ_j P dP − dO·O_bf16| ≤ 2^-9 (Σ_d |dO_d O_d| + Σ_j Pd_ij |dO·V_j|)."""
    rate, seed, n = 0.1, 11, 256
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(6, h=2, n=n))
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    out = flash_self_attention_reference(q, k, v, rate, seed, 256)
    s = torch.matmul((q * torch.tensor(q.shape[-1] ** -0.5,
                                       dtype=torch.bfloat16)).float(),
                     k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    keep = dropout_keep_mask(seed, rate, 2, n, 256).reshape(1, 2, n, n)
    pd = p * keep.float() / (1.0 - rate)
    dov = torch.matmul(do.float(), v.float().transpose(-1, -2))   # dO·V_j
    exact = (pd * dov).sum(-1)
    delta = (do.float() * out.float()).sum(-1)
    limit = 2.0 ** -9 * ((do.float() * out.float()).abs().sum(-1)
                         + (pd * dov.abs()).sum(-1)) + 1e-5
    assert bool(((exact - delta).abs() <= limit).all())
    assert float((exact - delta).abs().max()) > 0     # they do differ


@pytest.mark.parametrize("n", [32, 100, 256, 300, 512, 2048, 8077])
def test_routing_rule_matches_jax(n):
    assert flash_block_q(n) == (256 if n % 256 == 0 else (n if n <= 256 else 0))
