"""Self-attention with the policy's hashed dropout mask, plain PyTorch: a
frozen copy of the port's plain version. The keep mask is a murmur3 hash of
(seed, bh·65536 + i, r, col), with i the index of the `block_q`-row query
block and r the row inside it, the mask the port's kernels apply.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    """Keep mask [bh, n, n] (bool) for heads 0 … bh − 1, computed in int64 arithmetic
    masked to 32 bits (torch.uint32 lacks most ops on the CPU)."""
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


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dropout_rate: float = 0.0,
                         dropout_seed: Optional[torch.Tensor] = None,
                         block_q: int = 256) -> torch.Tensor:
    """The port's entry's contract on the plain version: N a multiple of
    `block_q`; `dropout_seed`, an int32 [1] CPU tensor, when dropping."""
    if q.shape[2] % block_q:
        raise ValueError(f"N={q.shape[2]} must be a multiple of block_q={block_q}")
    seed = None
    if dropout_rate > 0.0:
        seed = int(torch.as_tensor(dropout_seed).reshape(-1)[0])
    return flash_self_attention_reference(q, k, v, dropout_rate, seed, block_q)
