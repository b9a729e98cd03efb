"""The flash self-attention's plain pieces and faults: attention rounded
in the order of the port's CUDA forward (`reference/flash.
flash_order_attention`), as sound as the plain formula's; the exact
float64 backward (`attention_grads_float64`) and the training check's
`attn_bwd` built on it (`correct.flash_backward_gap`); the planted faults
in the flash forward and backward (`faults.py`)."""

import pytest
import torch

from benchmark.correct import flash_backward_gap
from benchmark.faults import SKIPPED_KEYS, SKIPPED_QUERIES, planted
from benchmark.reference.flash import (attention_grads_float64,
                                       dropout_keep_mask,
                                       flash_order_attention,
                                       flash_self_attention_reference)

# several 128-key tiles, two 256-row query blocks of the dropout mask
B, H, N, D, BLOCK_Q = 1, 2, 512, 64, 256
RATE, SEED = 0.1, 2 ** 31 + 7


def _qkv(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    # scores wide enough that a row's weight sits on a few keys, as in the
    # policy's layers, and the running max moves from tile to tile
    q, k, v = (torch.randn(B, H, N, D, generator=g) * s
               for s in (3.0, 3.0, 1.0))
    return [t.to(dtype) for t in (q, k, v)]


def _float64(q, k, v, rate):
    """Softmax attention in float64 on the same operands, scale and mask."""
    qs = (q * torch.tensor(D ** -0.5, dtype=q.dtype)).double()
    p = torch.softmax(qs @ k.double().transpose(-1, -2), dim=-1)
    if rate > 0.0:
        keep = dropout_keep_mask(SEED, rate, B * H, N, BLOCK_Q)
        p = p * keep.reshape(B, H, N, N).double() / (1.0 - rate)
    return p @ v.double()


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_flash_order_matches_float64(rate):
    q, k, v = _qkv(torch.float32)
    out = flash_order_attention(q, k, v, rate, SEED, BLOCK_Q)
    want = _float64(q, k, v, rate)
    assert out.dtype == torch.float32
    # fp32 scores of up to ≈ 30 bound the error, as in the plain formula
    assert float((out.double() - want).norm() / want.norm()) < 4e-6
    assert float((out.double() - want).abs().max()) < 4e-5


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_flash_order_equals_plain_in_float32(rate):
    q, k, v = _qkv(torch.float32, seed=1)
    a = flash_order_attention(q, k, v, rate, SEED, BLOCK_Q)
    b = flash_self_attention_reference(q, k, v, rate, SEED, BLOCK_Q)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_flash_order_rounds_otherwise_in_bfloat16(rate):
    """The kernel's order is no copy of the plain formula's: in bfloat16
    some outputs round otherwise, each as near float64 as the plain
    formula's."""
    q, k, v = _qkv(torch.bfloat16, seed=2)
    a = flash_order_attention(q, k, v, rate, SEED, BLOCK_Q)
    b = flash_self_attention_reference(q, k, v, rate, SEED, BLOCK_Q)
    assert a.dtype == torch.bfloat16
    differ = float((a != b).double().mean())
    assert 0.005 < differ < 0.5, differ
    want = _float64(q, k, v, rate)
    err_a = float((a.double() - want).norm() / want.norm())
    err_b = float((b.double() - want).norm() / want.norm())
    assert err_a < 1e-2 and err_a < 2 * err_b, (err_a, err_b)


def test_flash_order_gradients_match_float64():
    q, k, v = (t.requires_grad_() for t in _qkv(torch.float32, seed=3))
    dout = torch.randn(B, H, N, D, generator=torch.Generator().manual_seed(4))
    flash_order_attention(q, k, v, RATE, SEED, BLOCK_Q).backward(dout)
    got = [t.grad.double() for t in (q, k, v)]
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    _float64(q64, k64, v64, RATE).backward(dout.double())
    for g, w in zip(got, (q64.grad, k64.grad, v64.grad)):
        assert float((g - w).norm() / w.norm()) < 1e-5


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_float64_backward_is_autograd_of_float64(rate):
    q, k, v = _qkv(torch.bfloat16, seed=6)
    dout = torch.randn(B, H, N, D, generator=torch.Generator().manual_seed(7))
    dout = dout.to(torch.bfloat16)
    got = attention_grads_float64(q, k, v, dout, rate, SEED, BLOCK_Q)
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    _float64(q64, k64, v64, rate).backward(dout.double())
    for g, w in zip(got, (q64.grad, k64.grad, v64.grad)):
        assert g.dtype == torch.float64
        assert float((g - w).norm() / w.norm()) < 1e-12


def _call(dtype, seed, rate=RATE):
    """A flash call as the training check keeps it, its gradients from
    autograd of the plain version in `dtype`."""
    q, k, v = (t.requires_grad_() for t in _qkv(dtype, seed=seed))
    dout = torch.randn(B, H, N, D, generator=torch.Generator().manual_seed(
        seed + 100)).to(dtype)
    flash_self_attention_reference(q, k, v, rate, SEED, BLOCK_Q).backward(dout)
    return {"q": q.detach(), "k": k.detach(), "v": v.detach(), "dout": dout,
            "dq": q.grad, "dk": k.grad, "dv": v.grad, "rate": rate,
            "seed": SEED, "block_q": BLOCK_Q}


def test_backward_gap_reads_rounding_and_sees_a_skipped_tile():
    cpu = torch.device("cpu")
    assert flash_backward_gap(torch, [_call(torch.float32, 8)], cpu) < 1e-5
    sound = flash_backward_gap(torch, [_call(torch.bfloat16, 9)], cpu)
    assert 1e-4 < sound < 0.1, sound
    broken = _call(torch.bfloat16, 9)
    broken["dq"] = broken["dq"].clone()
    broken["dq"][:, :, SKIPPED_QUERIES] = 0
    assert flash_backward_gap(torch, [broken], cpu) > 10 * sound
    # a call whose backward never ran is not read
    assert flash_backward_gap(torch, [{"q": broken["q"]}], cpu) is None


def test_flash_backward_fault_zeroes_a_query_tile_and_is_restored():
    import manigaussian_tpu_torch.models.perceiver as P
    attend = P.flash_self_attention
    seed = torch.tensor([SEED % 2 ** 31], dtype=torch.int32)

    def grads(fn):
        q, k, v = (t.requires_grad_() for t in _qkv(torch.float32, seed=10))
        out = fn(q, k, v, RATE, seed, BLOCK_Q)
        out.backward(torch.ones_like(out))
        return out.detach(), q.grad, k.grad

    out, dq, dk = grads(attend)
    with planted("flash_backward"):
        assert P.flash_self_attention is not attend
        out_b, dq_b, dk_b = grads(P.flash_self_attention)
    assert P.flash_self_attention is attend
    assert torch.equal(out, out_b) and torch.equal(dk, dk_b)
    assert float(dq_b[:, :, SKIPPED_QUERIES].abs().max()) == 0.0
    assert float(dq[:, :, SKIPPED_QUERIES].abs().max()) > 0.0
    rest = torch.ones(N, dtype=torch.bool)
    rest[SKIPPED_QUERIES] = False
    assert torch.equal(dq[:, :, rest], dq_b[:, :, rest])


def test_flash_forward_fault_skips_a_key_tile_and_is_restored():
    import manigaussian_tpu_torch.models.perceiver as P
    attend = P.flash_self_attention
    q, k, v = _qkv(torch.float32, seed=5)
    seed = torch.tensor([SEED % 2 ** 31], dtype=torch.int32)
    sound = attend(q, k, v, RATE, seed, BLOCK_Q)
    with planted("flash_forward"):
        assert P.flash_self_attention is not attend
        broken = P.flash_self_attention(q, k, v, RATE, seed, BLOCK_Q)
    assert P.flash_self_attention is attend
    # the same row sums, without the skipped tile's P·V
    zeroed = v.clone()
    zeroed[:, :, SKIPPED_KEYS] = 0.0
    torch.testing.assert_close(broken, attend(q, k, zeroed, RATE, seed,
                                              BLOCK_Q))
    assert float((broken - sound).abs().max()) > 0.1
