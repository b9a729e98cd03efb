"""Self-attention with the policy's hashed dropout mask, plain PyTorch: a
frozen copy of the port's plain version. The keep mask is a murmur3 hash of
(seed, bh·65536 + i, r, col), with i the index of the `block_q`-row query
block and r the row inside it, the mask the port's kernels apply. The
plain version rounds as the plain formula does; `flash_order_attention` as
the port's CUDA forward does, as soundly (its tests show both);
`attention_grads_float64` is the exact backward that the training check
holds the program's flash backward to.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
# the keys of one tile of the port's CUDA forward (`kFwdKeys`)
FLASH_KEYS = 128


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


def flash_order_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          block_q: int = 256) -> torch.Tensor:
    """The same attention, the same keep mask, rounded in the order of the
    port's CUDA forward (`csrc/flash_attention.cu`: the online softmax of a
    tile, :403-430; the output's scale, :524-536) rather than the plain
    version's.

    q*scale in q's dtype as there; then for each tile of `FLASH_KEYS` keys,
    in key order: fp32 scores, the running row max m, p = exp(s − m) in
    fp32, unnormalized, the row sum l = l·α + Σ p over the undropped p, the
    dropped p rounded to v's dtype, O = O·α + P·V with fp32 products of the
    upcast operands (α = exp(m_old − m)); at the end O · (1/(1 − rate)) / l
    in q's dtype. The plain version rounds the normalized probabilities
    instead, so the two agree to fp32 rounding in float32 and round
    otherwise, as soundly, in bfloat16. The running max is held out of
    autograd: the output does not depend on it.
    """
    b, h, n, d = q.shape
    qs = (q * torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)).float()
    keep = None
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, dropout_rate, b * h, n,
                                 block_q, q.device).reshape(b, h, n, n)
    m = qs.new_full((b, h, n, 1), float("-inf"))
    l = qs.new_zeros((b, h, n, 1))
    o = qs.new_zeros((b, h, n, v.shape[-1]))
    for key0 in range(0, n, FLASH_KEYS):
        cols = slice(key0, key0 + FLASH_KEYS)
        s = torch.matmul(qs, k[:, :, cols].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True)).detach()
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = p * keep[..., cols]
        o = o * alpha + torch.matmul(p.to(v.dtype).float(),
                                     v[:, :, cols].float())
        m = m_new
    scale = torch.ones((), dtype=torch.float32, device=q.device)
    if dropout_rate > 0.0:      # 1 / (1 − rate) in fp32, as the kernel's
        scale = scale / (1.0 - torch.tensor(dropout_rate, dtype=torch.float32,
                                            device=q.device))
    return (o * (scale / l)).to(q.dtype)


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


def attention_grads_float64(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            dropout_rate: float = 0.0,
                            dropout_seed: Optional[int] = None,
                            block_q: int = 256):
    """(dq, dk, dv) of the same attention in float64, from the operands as
    they are (a bf16 q, k, v and dout upcast exactly), the scale rounded to
    q's dtype as the forward rounds it and the same keep mask: the exact
    gradient that a backward of these operands approximates. Written out
    (S = q·s·kᵀ, P = softmax S, P̃ = P ∘ keep / (1 − rate), O = P̃·v):
    dv = P̃ᵀ·dO, dP = (dO·vᵀ) ∘ keep / (1 − rate),
    dS = P ∘ (dP − rowsum(dP ∘ P)), dq = s·dS·k, dk = dSᵀ·(q·s)."""
    b, h, n, d = q.shape
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    q64, k64, v64, do = (t.double() for t in (q, k, v, dout))
    p = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1)
    drop = None
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, dropout_rate, b * h, n,
                                 block_q, q.device).reshape(b, h, n, n)
        drop = keep.double() / (1.0 - dropout_rate)
    pd = p if drop is None else p * drop
    dv = pd.transpose(-1, -2) @ do
    dp = do @ v64.transpose(-1, -2)
    if drop is not None:
        dp = dp * drop
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    del p, pd, dp, drop
    return ds @ k64 * scale, ds.transpose(-1, -2) @ q64 * scale, dv
