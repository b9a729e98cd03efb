"""CLIP RN50 text tower (port of `manigaussian_tpu/models/clip_text.py`;
reference `helpers/clip/core/clip.py:462-495`
encode_text_with_embeddings).

Token embedding (49408 × 512) + positional embedding (77 × 512) → 12
residual attention blocks (8 heads, the additive −inf causal mask, QuickGELU
MLP × 4, pre-LayerNorm) → ln_final → the per-token embeddings [77, 512]; the
sentence embedding is ln_final's output at the EOT position (the argmax of
the token ids) projected 512 → 1024 by `text_projection`. The attention is a
matmul and a softmax written out, as JAX computes it. fp32; the tower is
frozen and runs once per task string.

Parameter names are OpenAI's, so an OpenAI CLIP state dict (a torch.jit
archive such as RN50.pt, or a plain state dict) loads as it is
(`load_openai_state_dict`, which drops the visual tower's keys);
`model_dims_from_state_dict` reads the dims, so small test checkpoints load
too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
WIDTH = 512
HEADS = 8
LAYERS = 12
EMBED_DIM = 1024  # RN50 joint space


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight [3W, W],
    in_proj_bias, out_proj), with the attention written out."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        d = w // self.heads
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        split = lambda t: t.reshape(b, n, self.heads, d).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        att = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(
            float(d), device=x.device).sqrt()
        att = torch.softmax(att + mask, dim=-1)
        o = torch.matmul(att, v).transpose(1, 2).reshape(b, n, w)
        return self.out_proj(o)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = _Attention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _Mlp(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))


class ClipTextTransformer(nn.Module):
    """forward(tokens [B, L] int) → (sentence [B, embed_dim],
    token_embs [B, L, width])."""

    def __init__(self, vocab_size: int = VOCAB_SIZE,
                 context_length: int = CONTEXT_LENGTH, width: int = WIDTH,
                 heads: int = HEADS, layers: int = LAYERS,
                 embed_dim: int = EMBED_DIM):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        # causal mask (clip.py:449-455): additive -inf above the diagonal
        self.register_buffer("attn_mask", torch.full(
            (context_length, context_length), float("-inf")).triu_(1),
            persistent=False)

    def init_params(self, generator: torch.Generator) -> "ClipTextTransformer":
        """The flax module's initializers (normal 0.02 / 0.01 / width^-0.5
        for the embeddings and the projection, lecun-normal-scaled
        projections in the blocks), from `generator`: random weights of the
        published shapes where no checkpoint is at hand."""
        width = self.text_projection.shape[0]
        with torch.no_grad():
            self.token_embedding.weight.normal_(0, 0.02, generator=generator)
            self.positional_embedding.normal_(0, 0.01, generator=generator)
            self.text_projection.normal_(0, width ** -0.5, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.normal_(0, m.weight.shape[1] ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
                elif isinstance(m, _Attention):
                    m.in_proj_weight.normal_(0, m.in_proj_weight.shape[1] ** -0.5,
                                             generator=generator)
                    m.in_proj_bias.zero_()
        return self

    def forward(self, tokens: torch.Tensor):
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.transformer.resblocks:
            x = blk(x, self.attn_mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        sent = x[torch.arange(x.shape[0], device=x.device), eot] \
            @ self.text_projection
        return sent, x


def load_openai_state_dict(path_or_sd) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP checkpoint (a path to a torch.jit archive or to a
    saved state dict of tensors, or a state dict) → the text tower's state
    dict in fp32 (the visual tower's keys are dropped)."""
    if isinstance(path_or_sd, (str, bytes, bytearray)) or hasattr(
            path_or_sd, "__fspath__"):
        try:
            sd = torch.jit.load(path_or_sd, map_location="cpu").state_dict()
        except RuntimeError:
            sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd
    keep = ("token_embedding.", "positional_embedding", "transformer.",
            "ln_final.", "text_projection")
    return {k: torch.as_tensor(v).detach().float().cpu()
            for k, v in sd.items() if k.startswith(keep)}


def model_dims_from_state_dict(sd: Mapping) -> Dict[str, int]:
    """The tower's dims from a checkpoint (small test towers too)."""
    vocab, width = tuple(sd["token_embedding.weight"].shape)
    layers = max(int(k.split(".")[2]) for k in sd
                 if k.startswith("transformer.resblocks.")) + 1
    return dict(vocab_size=vocab,
                context_length=sd["positional_embedding"].shape[0],
                width=width, layers=layers,
                embed_dim=sd["text_projection"].shape[1])
