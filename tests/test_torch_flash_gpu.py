"""The CUDA flash kernel against its plain PyTorch version, on the card.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_flash_gpu.py -m gpu

Tolerances: 1e-5 in fp32 with TF32 off (the same fp32 math in another
summation order), 2e-2 in bf16 (the kernel rounds unnormalized probabilities
to bf16, the plain version normalized ones; bf16's step is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops.flash_attention import (
    flash_self_attention, flash_self_attention_reference)


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
