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
block and r the row inside it (`dropout_keep_mask`). The kernels hash
fmix(row part ^ column part) (`dropout_row_part`, `dropout_col_part`), each
part mixed once (`dropout_keep_from_parts` has their steps). In
training the bf16 forward also writes the mask as bits (`dropout_keep_bits`,
`keep_bits_words` words a row), which the bf16 backward reads instead of
hashing.

A call on the rows of one rank of a data-parallel batch passes `bh_offset`,
its first global row × heads: the hash then takes each head's global index,
so the rank drops what the one-device call drops on those rows (every mask
function here and the kernels take it; the bf16 backward reads the
forward's bits and hashes nothing).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from manigaussian_tpu_torch.ops import _cuda
from manigaussian_tpu_torch.utils.device import constant

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


def dropout_mix(part: torch.Tensor) -> torch.Tensor:
    """part ^ (part >> 16): the first step of murmur3's finaliser, which the
    kernels take on the row part and the column part alone (it distributes
    over their XOR), once per row and once per key."""
    return part ^ (part >> 16)


def dropout_keep_from_parts(row_part: torch.Tensor, col_part: torch.Tensor,
                            rate: float) -> torch.Tensor:
    """Keep test of the kernels on the row part and column part (int64 values
    in [0, 2^32), broadcast): the rest of murmur3's finaliser on their mixed
    parts (`dropout_mix`), its last step h ^= h >> 16 folded into the
    compare, h ^ (T >> 16) >= T for the threshold T."""
    h = dropout_mix(row_part) ^ dropout_mix(col_part)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    t = dropout_threshold(rate)
    return (h ^ (t >> 16)) >= t


def dropout_row_part(seed: int, bh: int, n: int, block_q: int,
                     device=None, bh_offset: int = 0) -> torch.Tensor:
    """[bh, n] int64: the part of the keep hash that depends on the query
    row only, (seed + ((bh_offset + bh)·65536 + row // block_q)·2654435761)
    ^ (row % block_q)·0x9E3779B1 mod 2^32, which the kernels compute once
    per row."""
    kw = dict(dtype=torch.int64, device=device)
    rows = torch.arange(n, **kw)
    heads = torch.arange(bh_offset, bh_offset + bh, **kw)
    base = (int(seed) + _mul32(heads[:, None] * 65536 + (rows // block_q)[None, :],
                               2654435761)) & _M32
    return base ^ _mul32(rows % block_q, 0x9E3779B1)[None, :]


def dropout_col_part(n: int, device=None) -> torch.Tensor:
    """[n] int64: the key column's part of the keep hash, col·0x85EBCA77 mod
    2^32."""
    return _mul32(torch.arange(n, dtype=torch.int64, device=device), 0x85EBCA77)


def keep_bits_words(n: int) -> int:
    """uint32 words a row of the keep bits: ⌈n/128⌉·4, so that the 128 keys
    of a forward tile are one 16-byte vector."""
    return (n + 127) // 128 * 4


def dropout_keep_bits(seed: int, rate: float, bh: int, n: int, block_q: int,
                      device=None, bh_offset: int = 0) -> torch.Tensor:
    """The keep mask as the bf16 forward writes it: [bh, n,
    keep_bits_words(n)] int32 holding uint32 words, bit c % 32 of word c // 32
    set where key c of the row is kept, 0 for c >= n."""
    keep = dropout_keep_mask(seed, rate, bh, n, block_q, device, bh_offset)
    words = keep_bits_words(n)
    padded = torch.zeros(bh, n, words * 32, dtype=torch.int64, device=device)
    padded[:, :, :n] = keep.long()
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                           device=device)
    packed = (padded.reshape(bh, n, words, 32) * weights).sum(-1)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)  # uint32 → int32


def unpack_keep_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """[bh, n, n] bool from `dropout_keep_bits`' layout."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = bits.long() & _M32
    keep = ((w[..., None] >> shifts) & 1).reshape(*bits.shape[:2], -1)
    return keep[..., :n].bool()


def dropout_keep_mask(seed: int, rate: float, bh: int, n: int, block_q: int,
                      device=None, bh_offset: int = 0) -> torch.Tensor:
    """Keep mask [bh, n, n] (bool) of `_dropout_mask` in the JAX kernel for
    heads bh_offset … bh_offset + bh − 1, computed in int64 arithmetic
    masked to 32 bits (torch.uint32 lacks most ops on the CPU)."""
    kw = dict(dtype=torch.int64, device=device)
    rows = torch.arange(n, **kw)
    blk, r = rows // block_q, rows % block_q
    heads = torch.arange(bh_offset, bh_offset + bh, **kw)
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
                                   block_q: int = 256,
                                   bh_offset: int = 0) -> torch.Tensor:
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
    qs = q * constant(scale, q.dtype, q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, dropout_rate, b * h, n,
                                 block_q, q.device,
                                 bh_offset).reshape(b, h, n, n)
        p = p * keep.float() * constant(1.0 / (1.0 - dropout_rate),
                                        torch.float32, q.device)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _cuda.load("flash_attention")
    if lib.flash_fwd_bf16.argtypes is None:
        # pointers and the stream as c_void_p: ctypes would pass a bare
        # Python int as a 32-bit int
        ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_float)
        tail = [f32, f32, u32, u32, i32, i32, ptr]
        # bf16: + keep_bits (forward); + qs scratch and keep_bits (backward)
        lib.flash_fwd_bf16.argtypes = [ptr] * 6 + [i32] * 3 + tail
        lib.flash_fwd_f32.argtypes = [ptr] * 5 + [i32] * 3 + tail
        lib.flash_bwd_bf16.argtypes = [ptr] * 12 + [i32] * 3 + tail
        lib.flash_bwd_f32.argtypes = [ptr] * 10 + [i32] * 3 + tail
        for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32, lib.flash_bwd_bf16,
                   lib.flash_bwd_f32):
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
                            block_q: int = 256, with_lse: bool = False,
                            bh_offset: int = 0):
    """Launch the forward kernel on CUDA tensors [B, H, N, D]: (out, lse,
    bits). lse [B·H, N] fp32 (the softmax's log-sum-exp per row) only when
    asked, else None; bits, the keep mask in `dropout_keep_bits`' layout that
    the bf16 backward reads, where the LSE comes with dropout in bf16, else
    None. Counted in `flash_self_attention.launches`."""
    _check(q, ("k", k), ("v", v))
    b, h, n, d = q.shape
    rate, seed, thresh = _dropout_args(dropout_rate, dropout_seed)
    lib = _library()
    out = torch.empty_like(q)
    lse = (torch.empty(b * h, n, dtype=torch.float32, device=q.device)
           if with_lse else None)
    bits = (torch.empty(b * h, n, keep_bits_words(n), dtype=torch.int32,
                        device=q.device)
            if with_lse and rate > 0.0 and q.dtype == torch.bfloat16 else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(lse)]
        if q.dtype == torch.bfloat16:
            fn, head = lib.flash_fwd_bf16, head + [ptr(bits)]
        else:
            fn = lib.flash_fwd_f32
        err = fn(*head, b * h, n, d, d ** -0.5, rate, seed, thresh, block_q,
                 bh_offset, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_self_attention.launches += 1
    return out, lse, bits


def flash_self_attention_backward(q, k, v, out, dout, lse,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None,
                                  block_q: int = 256,
                                  keep_bits: Optional[torch.Tensor] = None,
                                  bh_offset: int = 0):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv) in q's dtype
    from the forward's inputs, its output, the output's gradient and its LSE;
    in bf16 with dropout also the forward's keep bits, which the kernels read
    instead of hashing the mask (the fp32 kernels hash it). One call counts
    one launch, whatever passes it takes (bf16: the dQ pass, which also
    writes the row sums of dO ∘ O, then the dK/dV pass)."""
    _check(q, ("k", k), ("v", v), ("out", out), ("dout", dout))
    b, h, n, d = q.shape
    if lse.shape != (b * h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous fp32 [{b * h}, {n}]")
    rate, seed, thresh = _dropout_args(dropout_rate, dropout_seed)
    wants_bits = rate > 0.0 and q.dtype == torch.bfloat16
    if (keep_bits is not None) != wants_bits or wants_bits and (
            keep_bits.shape != (b * h, n, keep_bits_words(n))
            or keep_bits.dtype != torch.int32 or not keep_bits.is_contiguous()
            or keep_bits.device != q.device):
        raise ValueError("keep_bits: the bf16 forward's [B·H, N, words] int32 "
                         "mask, required with dropout in bf16 and only then")
    lib = _library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(b * h, n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr()]
        if q.dtype == torch.bfloat16:
            qs = torch.empty_like(q)   # q·scale in bf16, the dK/dV pass's operand
            fn = lib.flash_bwd_bf16
            head += [qs.data_ptr(),
                     keep_bits.data_ptr() if keep_bits is not None else None]
        else:
            fn = lib.flash_bwd_f32
        err = fn(*head, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, n,
                 d, d ** -0.5, rate, seed, thresh, block_q, bh_offset, stream)
    if err:
        raise RuntimeError(f"flash attention backward launch failed: CUDA error {err}")
    flash_self_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel route: forward kernel, then backward kernel. In training
    with dropout (bf16) the forward's keep bits are saved with its LSE, and
    the backward reads them instead of hashing the mask again."""

    @staticmethod
    def forward(ctx, q, k, v, rate, seed, block_q, bh_offset):
        need_grad = any(ctx.needs_input_grad[:3])
        out, lse, bits = flash_attention_forward(q, k, v, rate, seed, block_q,
                                                 with_lse=need_grad,
                                                 bh_offset=bh_offset)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse, bits)
        ctx.args = (rate, seed, block_q)
        ctx.bh_offset = bh_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bits = ctx.saved_tensors
        dq, dk, dv = flash_self_attention_backward(
            q, k, v, out, dout.contiguous(), lse, *ctx.args, keep_bits=bits,
            bh_offset=ctx.bh_offset)
        return dq, dk, dv, None, None, None, None


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[torch.Tensor] = None,
                         block_q: int = 256,
                         bh_offset: int = 0) -> torch.Tensor:
    """Multi-head self-attention, [B, H, N, D] → [B, H, N, D] in q's dtype.

    Same signature and contract as the JAX function (N must be a multiple of
    `block_q`; `dropout_seed`, an int32 [1] tensor on the CPU, is required
    when dropout_rate > 0); the CUDA kernels tile by 128 and 64 rows
    whatever `block_q`, which only places the dropout mask. `bh_offset`: the
    global batch·head index of q's first head (rank r of a data-parallel
    batch passes its first global row × H).
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
                                              block_q, bh_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, float(dropout_rate), seed, block_q,
                                 int(bh_offset))


# launches of the CUDA kernels (the plain versions are not counted)
flash_self_attention.launches = 0
flash_self_attention_backward.launches = 0
