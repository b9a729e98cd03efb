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
    dropout_keep_bits, flash_attention_forward, flash_self_attention,
    flash_self_attention_backward, flash_self_attention_reference)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,d,tol", [
    ("bfloat16", 2048, 64, 2e-2),
    ("float32", 2048, 64, 1e-5),
    ("bfloat16", 256, 64, 2e-2),
    ("bfloat16", 512, 32, 2e-2),
    ("bfloat16", 100, 16, 2e-2),   # ragged: partial tiles of rows and keys
    ("bfloat16", 100, 64, 2e-2),
    ("float32", 100, 32, 1e-5),
    ("float32", 512, 64, 1e-5),
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
    ("bfloat16", 256, 64, 0.0), ("bfloat16", 256, 64, 0.1),
    ("bfloat16", 512, 32, 0.0), ("bfloat16", 512, 32, 0.1),
    ("bfloat16", 100, 16, 0.1),
    ("bfloat16", 100, 64, 0.0), ("bfloat16", 100, 64, 0.1),
    ("float32", 2048, 64, 0.0), ("float32", 2048, 64, 0.1),
    ("float32", 512, 64, 0.0), ("float32", 32, 8, 0.0),
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


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,rate", [
    (2048, 64, 0.0), (2048, 64, 0.1), (256, 64, 0.1), (512, 32, 0.0),
    (512, 32, 0.1), (100, 16, 0.0), (100, 16, 0.1), (100, 64, 0.1),
])
def test_bf16_kernels_with_and_without_lse(n, d, rate):
    """The bf16 forward without the LSE (act's call) and with it and the
    keep bits (training's) against the plain version; the bits equal
    `dropout_keep_bits`; the backward bitwise repeatable, and with dropout
    refused without the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 8, n, d)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(4))
    bq = n if n <= 256 else 256
    seed = 99
    ref = flash_self_attention_reference(q, k, v, rate, seed, bq).float().cpu()
    out, lse, bits = flash_attention_forward(q, k, v, rate, seed, bq)
    assert lse is None and bits is None
    out_t, lse, bits = flash_attention_forward(q, k, v, rate, seed, bq,
                                               with_lse=True)
    torch.cuda.synchronize()
    for o in (out, out_t):
        np.testing.assert_allclose(o.float().cpu().numpy(), ref.numpy(),
                                   atol=2e-2, rtol=2e-2)
    assert (bits is not None) == (rate > 0)
    if bits is not None:
        assert torch.equal(bits.cpu(), dropout_keep_bits(seed, rate, 8, n, bq))
    runs = [flash_self_attention_backward(q, k, v, out_t, g, lse, rate,
                                          seed, bq, keep_bits=bits)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    if bits is not None:
        with pytest.raises(ValueError, match="keep_bits"):
            flash_self_attention_backward(q, k, v, out_t, g, lse, rate,
                                          seed, bq)


# (dtype, N, head dim, forward tolerance): the policy's shape and ragged ones
# in bf16, and fp32 at the policy's shape, at a multiple of the 256-row block
# and at the micro configs' latent attention
SHAPES = [("bfloat16", 2048, 64, 2e-2), ("bfloat16", 256, 64, 2e-2),
          ("bfloat16", 512, 32, 2e-2), ("bfloat16", 100, 16, 2e-2),
          ("bfloat16", 100, 64, 2e-2), ("float32", 2048, 64, 1e-5),
          ("float32", 512, 64, 1e-5), ("float32", 32, 8, 1e-5)]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,n,d,tol", SHAPES)
def test_cuda_forward_without_lse_and_a_repeatable_backward(dtype, n, d, tol,
                                                            rate):
    """The forward without the LSE (act's call) within `tol` of the plain
    version at the same dropout; dq, dk and dv of two backward calls on the
    forward with the LSE (and in bf16 with dropout its keep bits) equal bit
    for bit: no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(1, 8, n, d, generator=gen, device="cuda")
                  .to(getattr(torch, dtype)) for _ in range(4))
    bq = n if n <= 256 else 256
    ref = flash_self_attention_reference(q, k, v, rate, 1234, bq)
    act = flash_attention_forward(q, k, v, rate, 1234, bq)[0]
    assert (act.float() - ref.float()).abs().max().item() <= tol
    out, lse, bits = flash_attention_forward(q, k, v, rate, 1234, bq,
                                             with_lse=True)
    runs = [flash_self_attention_backward(q, k, v, out, g, lse, rate, 1234,
                                          bq, keep_bits=bits)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,tol", [("bfloat16", 2048, 2e-2),
                                         ("float32", 512, 1e-5)])
def test_cuda_forward_on_a_ranks_rows_with_bh_offset(dtype, n, tol):
    """One data-parallel rank's rows, 2-3 of a batch of 4 at [·, 8, n, 64],
    dropout 0.1, `bh_offset` 2·8: the output (and in bf16 the keep bits)
    equals rows 2-3 of the whole batch's call bit for bit, and the plain
    version at the same offset within the forward's tolerance; in fp32,
    whose backward hashes the mask again, the rank's dq, dk, dv equal the
    whole batch's rows bit for bit too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.randn(4, 8, n, 64, generator=gen, device="cuda").to(dt)
                  for _ in range(4))
    seed, rate, lo = 4321, 0.1, 2
    whole, lse_w, bits_w = flash_attention_forward(q, k, v, rate, seed, 256,
                                                   with_lse=True)
    qr, kr, vr = (x[lo:].contiguous() for x in (q, k, v))
    part, lse_p, bits_p = flash_attention_forward(qr, kr, vr, rate, seed, 256,
                                                  with_lse=True,
                                                  bh_offset=lo * 8)
    ref = flash_self_attention_reference(qr, kr, vr, rate, seed, 256,
                                         bh_offset=lo * 8)
    torch.cuda.synchronize()
    assert torch.equal(part, whole[lo:])
    assert (bits_p is None) == (bits_w is None) == (dtype == "float32")
    if bits_p is not None:
        assert torch.equal(bits_p, bits_w[lo * 8:])
    assert (part.float() - ref.float()).abs().max().item() <= tol
    if dtype == "float32":
        gw = flash_self_attention_backward(q, k, v, whole, g, lse_w, rate,
                                           seed, 256)
        gp = flash_self_attention_backward(qr, kr, vr, part,
                                           g[lo:].contiguous(), lse_p, rate,
                                           seed, 256, bh_offset=lo * 8)
        for a, b in zip(gw, gp):
            assert torch.equal(a[lo:], b)
