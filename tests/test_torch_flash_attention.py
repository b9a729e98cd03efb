"""The port's flash self-attention (manigaussian_tpu_torch/ops/flash_attention.py)
against the JAX Pallas kernel (interpret mode on the CPU).

On the CPU the wrapper runs its plain PyTorch version, so these cases hold
that version to the TPU kernel's arithmetic. Tolerances are those of
tests/test_flash_attention.py: 1e-5 in fp32 (the same fp32 math in another
summation order), 2e-2 in bf16 (probabilities and output are rounded to
bf16, whose step is 2^-8 relative). The CUDA kernel itself is held to the
plain version on the card by tests/test_torch_flash_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.flash_attention import \
    flash_self_attention as jax_flash
from manigaussian_tpu_torch.models.perceiver import flash_block_q
from manigaussian_tpu_torch.ops.flash_attention import (
    flash_self_attention, flash_self_attention_reference)
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
    with pytest.raises(NotImplementedError):
        flash_self_attention(q, k, v, dropout_rate=0.1, block_q=64)
    before = flash_self_attention.launches
    flash_self_attention(q, k, v, block_q=64)
    assert flash_self_attention.launches == before  # plain version: no launch


@pytest.mark.parametrize("n", [32, 100, 256, 300, 512, 2048, 8077])
def test_routing_rule_matches_jax(n):
    assert flash_block_q(n) == (256 if n % 256 == 0 else (n if n <= 256 else 0))
