"""3D visual-language attention blocks (port of
`manigaussian_tpu/models/attention3d.py`; reference
`agents/manigaussian_bc/attention.py:92-420`, an optional library for
fusing language into 3D feature volumes that the main model does not use).

Volumes are channels-last, [B, D, H, W, C], as in the JAX package. Its
1×1×1 convolutions are per-voxel linear maps, so they are `blocks.Dense`
here, as its dense layers are (`convert.attention3d_state_dict` reads
flax's DHWIO kernels), and `blocks.initialize` draws flax's initializers.
As in flax: LayerNorm eps 1e-6, the tanh GELU, the cross-attention's
logits and softmax in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from manigaussian_tpu_torch.models.blocks import Dense

LN_EPS = 1e-6


def _heads(t: torch.Tensor, b: int, heads: int, dim_head: int):
    return t.reshape(b, -1, heads, dim_head).transpose(1, 2)


class LinearAttention3D(nn.Module):
    """O(N) kernelized self-attention over voxel tokens: softmax(q) over
    the head's features, softmax(k) over the tokens, q·(kᵀv)."""

    def __init__(self, channels: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(channels, 3 * inner, use_bias=False)
        self.to_out = Dense(inner, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, _ = x.shape
        inner = self.heads * self.dim_head
        q, k, v = (_heads(t, b, self.heads, self.dim_head) for t in
                   self.to_qkv(x).reshape(b, d * h * w, 3 * inner)
                   .chunk(3, dim=-1))
        q = torch.softmax(q, dim=-1)
        k = torch.softmax(k, dim=-2)
        ctx = torch.einsum("bhnd,bhne->bhde", k, v)
        out = torch.einsum("bhnd,bhde->bhne", q, ctx)
        return self.to_out(out.transpose(1, 2).reshape(b, d, h, w, inner))


class CrossAttention3D(nn.Module):
    """Voxel tokens [B, D, H, W, C] attend to language tokens [B, L, Cl]."""

    def __init__(self, channels: int, context_dim: int, heads: int = 4,
                 dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Dense(channels, inner, use_bias=False)
        self.to_k = Dense(context_dim, inner, use_bias=False)
        self.to_v = Dense(context_dim, inner, use_bias=False)
        self.to_out = Dense(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        split = lambda t: _heads(t, b, self.heads, self.dim_head)  # noqa: E731
        q = split(self.to_q(x.reshape(b, d * h * w, c)))
        k, v = split(self.to_k(context)), split(self.to_v(context))
        logits = torch.einsum("bhnd,bhmd->bhnm",
                              (q * self.dim_head ** -0.5).float(), k.float())
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, d * h * w, -1)
        return self.to_out(out).reshape(b, d, h, w, c)


class Visual3DLangTransformer(nn.Module):
    """Linear self-attention, language cross-attention and an MLP over a
    voxel volume, each pre-normed and residual."""

    def __init__(self, channels: int, context_dim: int, heads: int = 4,
                 dim_head: int = 32, mlp_mult: int = 2):
        super().__init__()
        self.norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.self_attn = LinearAttention3D(channels, heads, dim_head)
        self.norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.cross_attn = CrossAttention3D(channels, context_dim, heads,
                                           dim_head)
        self.norm3 = nn.LayerNorm(channels, eps=LN_EPS)
        self.ff_in = Dense(channels, channels * mlp_mult)
        self.ff_out = Dense(channels * mlp_mult, channels)

    def forward(self, x: torch.Tensor, lang_tokens: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), lang_tokens)
        h = self.ff_in(self.norm3(x))
        return x + self.ff_out(F.gelu(h, approximate="tanh"))
