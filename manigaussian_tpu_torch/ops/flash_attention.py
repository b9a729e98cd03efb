"""Flash self-attention forward: the wrapper of the CUDA kernel and its plain
PyTorch version.

The kernel (`csrc/flash_attention.cu`) replaces the TPU kernel `_fwd_kernel`
reached through `_flash_fwd_impl` in `manigaussian_tpu/ops/flash_attention.py`.
Its bound on an H100 at the policy's shapes ([1, 8, 2048, 64] bf16) is the
tensor-core rate: 8.6 GFLOP / 989 TFLOP/s ≈ 8.7 us a launch, against ≈ 2.5 us
for its 8.4 MB of q, k, v and out at 3.35 TB/s. The design note is in the
source.

`flash_self_attention` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. Dropout (training only)
is not ported yet: a rate > 0 raises on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from manigaussian_tpu_torch.ops import _cuda

# head dims with an instantiation in csrc/flash_attention.cu (the bf16
# tensor-core path needs multiples of 16)
_HEAD_DIMS = {torch.bfloat16: (16, 32, 64), torch.float32: (8, 16, 32, 64)}


def flash_self_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """The plain version: the TPU kernel's arithmetic in PyTorch ops.

    q*scale in q's dtype (the scale rounded to that dtype first, as
    `q_blk * jnp.asarray(scale, dtype)`; torch's `q * float` would keep the
    scale in fp32), fp32 scores and softmax, probabilities rounded to v's
    dtype, fp32 P·V, output in q's dtype. Operands are upcast exactly before
    each product, so with TF32 off the products are the fp32-accumulated
    ones of the JAX `preferred_element_type=float32` dots.
    """
    scale = q.shape[-1] ** -0.5
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _cuda.load("flash_attention")
    if lib.flash_fwd_bf16.argtypes is None:
        for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
            # pointers and the stream as c_void_p: ctypes would pass a bare
            # Python int as a 32-bit int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device: "
                             f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype not in _HEAD_DIMS:
        raise TypeError(f"flash kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash kernel head dim for {q.dtype} must be one of "
                         f"{_HEAD_DIMS[q.dtype]}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[torch.Tensor] = None,
                         block_q: int = 256) -> torch.Tensor:
    """Multi-head self-attention, [B, H, N, D] → [B, H, N, D] in q's dtype.

    Same signature and contract as the JAX function (N must be a multiple of
    `block_q`); the CUDA kernel tiles queries by 64 rows whatever `block_q`.
    """
    b, h, n, d = q.shape
    if n % block_q:
        raise ValueError(f"N={n} must be a multiple of block_q={block_q}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (it comes with training)")
    if q.device.type == "cpu":
        return flash_self_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    lib = _library()
    fn = lib.flash_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_fwd_f32
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, n, d, d ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_self_attention.launches += 1
    return out


# launches of the CUDA kernel (the plain version is not counted)
flash_self_attention.launches = 0
