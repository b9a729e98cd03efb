"""The CUDA flash kernels (forward with dropout, backward) against their
plain PyTorch version, on the card.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_flash_gpu.py -m gpu

Tolerances: 1e-5 in fp32 with TF32 off (the same fp32 math in another
summation order), 2e-2 in bf16 (the kernel rounds unnormalized probabilities
to bf16, the plain version normalized ones; bf16's step is 2^-8 relative).
Gradients against autograd of the plain version: bf16 2e-2, fp32 1e-4, of
max(1, their largest magnitude) (sums over N keys in another order).
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops.flash_attention import (
    flash_self_attention, flash_self_attention_backward,
    flash_self_attention_reference)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,d,tol", [
    ("bfloat16", 2048, 64, 2e-2),
    ("float32", 2048, 64, 1e-5),
    ("bfloat16", 256, 64, 2e-2),
    ("bfloat16", 512, 32, 2e-2),
    ("bfloat16", 100, 16, 2e-2),   # ragged: partial tiles of rows and keys
    ("float32", 100, 32, 1e-5),
    ("float32", 32, 8, 1e-5),      # the micro configs' latent attention
])
def test_cuda_kernel_matches_plain_version(dtype, n, d, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, n, d)).astype(
        np.float32)).to("cuda", getattr(torch, dtype)) for _ in range(3))
    before = flash_self_attention.launches
    out = flash_self_attention(q, k, v, block_q=n if n <= 256 else 256)
    torch.cuda.synchronize()
    assert flash_self_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        flash_self_attention_reference(q, k, v).float().cpu().numpy(),
        atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,d,rate", [
    ("bfloat16", 2048, 64, 0.1),
    ("bfloat16", 2048, 64, 0.0),
    ("float32", 512, 64, 0.1),
    ("bfloat16", 256, 32, 0.1),
    ("bfloat16", 100, 16, 0.0),    # ragged
    ("float32", 32, 8, 0.1),       # the micro configs' latent attention
])
def test_cuda_backward_and_dropout_match_plain_version(dtype, n, d, rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 8, n, d)).astype(
        np.float32)).to("cuda", dt) for _ in range(4))
    bq = n if n <= 256 else 256
    seed = 4321
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_self_attention_backward.launches
    out = flash_self_attention(*leaves, dropout_rate=rate,
                               dropout_seed=torch.tensor([seed]), block_q=bq)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert flash_self_attention_backward.launches == before + 1
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_self_attention_reference(*ref_leaves, rate, seed, bq)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               ref.detach().float().cpu().numpy(), atol=tol,
                               rtol=tol)
    gtol = 2e-2 if dtype == "bfloat16" else 1e-4
    for a, b in zip(grads, ref_grads):
        b = b.float().cpu().numpy()
        np.testing.assert_allclose(a.float().cpu().numpy(), b, rtol=0,
                                   atol=gtol * max(1.0, float(np.abs(b).max())))
