"""Flash self-attention: the wrappers of the CUDA kernels (forward with
dropout, backward) and their plain PyTorch versions.

The kernels (`csrc/flash_attention.cu`) replace the TPU kernels `_fwd_kernel`
(reached through `_flash_fwd_impl`) and `_bwd_kernel` (through
`_flash_bwd_impl`) in `manigaussian_tpu/ops/flash_attention.py`. Their bounds
on an H100 at the policy's shapes ([1, 8, 2048, 64] bf16) are the tensor-core
rate: 8.6 GFLOP ≈ 8.7 us for the forward, 21.5 GFLOP ≈ 21.7 us for the
backward. The design notes are in the source.

`flash_self_attention` takes the plain version only for tensors on the CPU
(autograd then differentiates the plain version); for CUDA tensors it is an
autograd Function whose forward and backward launch the kernels, or raise.

Dropout reproduces the TPU kernel's keep mask bit for bit: a murmur3 hash of
(seed, bh·65536 + i, r, col) with i the index of the `block_q`-row query
block and r the row inside it (`dropout_keep_mask`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from manigaussian_tpu_torch.ops import _cuda

# head dims with an instantiation in csrc/flash_attention.cu (the bf16
# tensor-core path needs multiples of 16)
_HEAD_DIMS = {torch.bfloat16: (16, 32, 64), torch.float32: (8, 16, 32, 64)}
_M32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """The TPU kernel's uint32 threshold: an element is kept where its hash
    is >= it."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for int64 a in [0, 2^32): in 16-bit halves of c, so
    that no int64 product overflows."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep_mask(seed: int, rate: float, bh: int, n: int, block_q: int,
                      device=None) -> torch.Tensor:
    """Keep mask [bh, n, n] (bool) of `_dropout_mask` in the JAX kernel,
    computed in int64 arithmetic masked to 32 bits (torch.uint32 lacks most
    ops on the CPU)."""
    kw = dict(dtype=torch.int64, device=device)
    rows = torch.arange(n, **kw)
    blk, r = rows // block_q, rows % block_q
    heads = torch.arange(bh, **kw)
    base = (int(seed) + _mul32(heads[:, None] * 65536 + blk[None, :],
                               2654435761)) & _M32                  # [bh, n]
    h = (base[:, :, None] ^ _mul32(r, 0x9E3779B1)[None, :, None]
         ^ _mul32(torch.arange(n, **kw), 0x85EBCA77)[None, None, :])
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= dropout_threshold(rate)


def flash_self_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, dropout_rate: float = 0.0,
                                   dropout_seed: Optional[int] = None,
                                   block_q: int = 256) -> torch.Tensor:
    """The plain version: the TPU kernel's arithmetic in PyTorch ops.

    q*scale in q's dtype (the scale rounded to that dtype first, as
    `q_blk * jnp.asarray(scale, dtype)`; torch's `q * float` would keep the
    scale in fp32), fp32 scores and softmax, dropout on the normalized fp32
    probabilities, probabilities rounded to v's dtype, fp32 P·V, output in
    q's dtype. Operands are upcast exactly before each product, so with TF32
    off the products are the fp32-accumulated ones of the JAX
    `preferred_element_type=float32` dots.
    """
    b, h, n, d = q.shape
    scale = d ** -0.5
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, dropout_rate, b * h, n,
                                 block_q, q.device).reshape(b, h, n, n)
        p = p * keep.float() * torch.tensor(
            1.0 / (1.0 - dropout_rate), dtype=torch.float32, device=q.device)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _cuda.load("flash_attention")
    if lib.flash_fwd_bf16.argtypes is None:
        # pointers and the stream as c_void_p: ctypes would pass a bare
        # Python int as a 32-bit int
        ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_float)
        for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
            fn.argtypes = [ptr] * 5 + [i32] * 3 + [f32, f32, u32, u32, i32, ptr]
            fn.restype = i32
        for fn in (lib.flash_bwd_bf16, lib.flash_bwd_f32):
            fn.argtypes = [ptr] * 10 + [i32] * 3 + [f32, f32, u32, u32, i32, ptr]
            fn.restype = i32
    return lib


def _check(q: torch.Tensor, *others: Tuple[str, torch.Tensor]) -> None:
    for name, t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device: "
                             f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {q.device}")
    if q.dtype not in _HEAD_DIMS:
        raise TypeError(f"flash kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash kernel head dim for {q.dtype} must be one of "
                         f"{_HEAD_DIMS[q.dtype]}, got {q.shape[-1]}")
    for name, t in (("q", q),) + others:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _dropout_args(rate: float, seed: Optional[int]):
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return (float(rate), int(seed or 0) & _M32,
            dropout_threshold(rate) if rate > 0.0 else 0)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None,
                            block_q: int = 256, with_lse: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel on CUDA tensors [B, H, N, D]: (out, lse),
    lse [B·H, N] fp32 (the softmax's log-sum-exp per row) only when asked.
    Counted in `flash_self_attention.launches`."""
    _check(q, ("k", k), ("v", v))
    b, h, n, d = q.shape
    rate, seed, thresh = _dropout_args(dropout_rate, dropout_seed)
    lib = _library()
    fn = lib.flash_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_fwd_f32
    out = torch.empty_like(q)
    lse = (torch.empty(b * h, n, dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, b * h, n, d, d ** -0.5,
                 rate, seed, thresh, block_q, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_self_attention.launches += 1
    return out, lse


def flash_self_attention_backward(q, k, v, out, dout, lse,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None,
                                  block_q: int = 256):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv) in q's dtype
    from the forward's inputs, its output, the output's gradient and its LSE.
    One call (a delta pass and two gradient passes) counts one launch."""
    _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout))
    b, h, n, d = q.shape
    if lse.shape != (b * h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [{b * h}, {n}]")
    rate, seed, thresh = _dropout_args(dropout_rate, dropout_seed)
    lib = _library()
    fn = lib.flash_bwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_bwd_f32
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(b * h, n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, n, d,
                 d ** -0.5, rate, seed, thresh, block_q, stream)
    if err:
        raise RuntimeError(f"flash attention backward launch failed: CUDA error {err}")
    flash_self_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel route: forward kernel, then backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, rate, seed, block_q):
        need_grad = any(ctx.needs_input_grad[:3])
        out, lse = flash_attention_forward(q, k, v, rate, seed, block_q,
                                           with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (rate, seed, block_q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_self_attention_backward(
            q, k, v, out, dout.contiguous(), lse, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[torch.Tensor] = None,
                         block_q: int = 256) -> torch.Tensor:
    """Multi-head self-attention, [B, H, N, D] → [B, H, N, D] in q's dtype.

    Same signature and contract as the JAX function (N must be a multiple of
    `block_q`; `dropout_seed`, an int32 [1] tensor on the CPU, is required
    when dropout_rate > 0); the CUDA kernels tile by 64 rows whatever
    `block_q`, which only places the dropout mask.
    """
    n = q.shape[2]
    if n % block_q:
        raise ValueError(f"N={n} must be a multiple of block_q={block_q}")
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout needs a seed")
        seed = int(torch.as_tensor(dropout_seed).reshape(-1)[0])
    if q.device.type == "cpu":
        return flash_self_attention_reference(q, k, v, dropout_rate, seed,
                                              block_q)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, float(dropout_rate), seed, block_q)


# launches of the CUDA kernels (the plain versions are not counted)
flash_self_attention.launches = 0
flash_self_attention_backward.launches = 0
