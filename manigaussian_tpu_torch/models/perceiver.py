"""Perceiver IO voxel/language policy encoder (the Q-attention net).

Port of `manigaussian_tpu/models/perceiver.py:41-307`:

  voxel [B,V³,10] → 3D U-Net (→128ch, d0) → patchify 5³ → +proprio → 256-ch
  tokens + 77 language tokens → +pos-enc → cross-attn into 2048×512 latents
  → `depth` self-attn blocks → decoder cross-attn → un-patchify (conv,
  trilinear ×5, conv) → skip-concat d0 → trans Q-head + rot/grip/collision
  MLP fed by three spatial-softmax+max summaries.

Self-attention with `impl="flash"` goes through ops/flash_attention.py (the
CUDA kernel on the card) under the JAX routing rule: query blocks of 256
when N % 256 == 0, one block when N ≤ 256, the plain path otherwise. Cross
attention always takes the plain path. The two paths differ in type as in
the JAX package: the flash path returns q's dtype, the plain one float32;
both feed `to_out`, which casts to the compute dtype.

Dropout is on only when `deterministic=False`, as in JAX, and draws from an
explicit CPU `torch.Generator`: the flash path takes a seed in
[0, 2³¹−1) per call for the kernel's hashed mask (`perceiver.py:82-84`);
the plain path (at w_geo the cross attention, rate `input_dropout`) a
Bernoulli keep mask on the probabilities, from a device generator seeded
from the same generator. On one rank of a data-parallel batch (`rows`, its
place in the global batch) both are drawn for the global batch: the plain
mask at the global shape, of which the rank keeps its rows, and the flash
seed as it is, with the rank's first global row × heads as the kernel's
`bh_offset`; so every rank drops what the one-process step drops.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from manigaussian_tpu_torch.models.blocks import (ChannelProjectConv3D,
                                                  Conv3DBlock,
                                                  Conv3DUpsampleBlock, Dense,
                                                  DenseBlock, Patchify3D,
                                                  init_weight_, layer_norm,
                                                  spatial_softmax3d_with_max)
from manigaussian_tpu_torch.models.unet3d import VoxelUNetShallow
from manigaussian_tpu_torch.ops.flash_attention import flash_self_attention
from manigaussian_tpu_torch.parallel.distributed import Rows, global_draw
from manigaussian_tpu_torch.utils.device import constant
from manigaussian_tpu_torch.utils.profiling import trace_annotation


def flash_block_q(n: int) -> int:
    """The JAX routing rule (perceiver.py:75): 0 means the plain path."""
    return 256 if n % 256 == 0 else (n if n <= 256 else 0)


class Attention(nn.Module):
    """Multi-head attention, optionally cross (perceiver_lang_io.py:102-145)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, impl: str = "xla"):
        super().__init__()
        inner = heads * dim_head
        self.to_q = Dense(query_dim, inner, use_bias=False, dtype=dtype)
        self.to_kv = Dense(context_dim, inner * 2, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)
        self.heads, self.dim_head, self.impl = heads, dim_head, impl
        self.dropout = dropout

    def forward(self, x, context=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None):
        is_self = context is None
        context = x if is_self else context
        q = self.to_q(x)
        k, v = self.to_kv(context).chunk(2, dim=-1)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).permute(0, 2, 1, 3)

        q, k, v = map(split_heads, (q, k, v))
        bq = flash_block_q(q.shape[2])
        rate = 0.0 if deterministic else float(self.dropout)
        if rate > 0.0 and generator is None:
            raise ValueError("attention dropout needs a generator")
        if self.impl == "flash" and is_self and bq:
            seed = None
            if rate > 0.0:
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     dtype=torch.int32)
            out = flash_self_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                dropout_rate=rate, dropout_seed=seed, block_q=bq,
                bh_offset=rows.lo * self.heads if rows else 0)
        else:
            scale = constant(self.dim_head ** -0.5, q.dtype, q.device)
            logits = torch.matmul((q * scale).float(),
                                  k.float().transpose(-1, -2))
            attn = torch.softmax(logits, dim=-1)
            if rate > 0.0:
                attn = _dropout(attn, rate, generator, rows)
            out = torch.matmul(attn.to(v.dtype).float(), v.float())
        b, _, n, _ = out.shape
        out = out.permute(0, 2, 1, 3).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
             rows: Optional[Rows] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, kept values scaled
    by 1/(1 - rate); the mask is drawn on x's device from a generator seeded
    by `generator`, for the global batch when `rows` places x's rows in
    it."""
    dev_gen = torch.Generator(device=x.device).manual_seed(
        int(torch.randint(0, 2 ** 62, (1,), generator=generator)))
    keep = global_draw(lambda n: torch.rand((n,) + x.shape[1:],
                                            generator=dev_gen,
                                            device=x.device),
                       x.shape[0], rows) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GEGLUFeedForward(nn.Module):
    """dim → dim*mult*2 → GEGLU (tanh gelu) → dim (perceiver_lang_io.py:84-100)."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(dim, dim * mult * 2, dtype=dtype)
        self.out = Dense(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        h, gates = self.proj(x).chunk(2, dim=-1)
        return self.out(h * nn.functional.gelu(gates, approximate="tanh"))


class PreNormAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int = 0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, impl: str = "xla"):
        """context_dim > 0 makes it cross attention (with its own norm)."""
        super().__init__()
        self.norm = layer_norm(dim)
        self.norm_context = layer_norm(context_dim) if context_dim else None
        self.attn = Attention(dim, context_dim or dim, heads, dim_head,
                              dropout=dropout, dtype=dtype, impl=impl)

    def forward(self, x, context=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None):
        cn = None if self.norm_context is None else self.norm_context(context)
        return self.attn(self.norm(x), context=cn, deterministic=deterministic,
                         generator=generator, rows=rows)


class PreNormFF(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = layer_norm(dim)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x):
        return self.ff(self.norm(x))


class PerceiverVoxelLangEncoder(nn.Module):
    """Same fields and defaults as the JAX module, plus the compute dtype as a
    torch dtype. Returns (trans_q [B,V,V,V,1], rot_grip_q [B,3R+2],
    collision_q [B,2], d0 [B,V,V,V,im_channels], lang [B,77,2·im])."""

    def __init__(self, depth: int = 6, iterations: int = 1,
                 voxel_size: int = 100, initial_dim: int = 10,
                 low_dim_size: int = 4, num_rotation_classes: int = 72,
                 num_grip_classes: int = 2, num_collision_classes: int = 2,
                 num_latents: int = 2048, im_channels: int = 128,
                 latent_dim: int = 512, cross_heads: int = 1,
                 latent_heads: int = 8, cross_dim_head: int = 64,
                 latent_dim_head: int = 64, activation: str = "lrelu",
                 lang_emb_dim: int = 512, lang_max_seq_len: int = 77,
                 input_dropout: float = 0.1, attn_dropout: float = 0.1,
                 decoder_dropout: float = 0.0, voxel_patch_size: int = 5,
                 voxel_patch_stride: int = 5,
                 final_dim: int = 128, no_skip_connection: bool = False,
                 no_perceiver: bool = False, no_language: bool = False,
                 unet_channels: Sequence[int] = (8, 16, 32, 64),
                 dtype: torch.dtype = torch.float32, pad_mode: str = "edge",
                 conv_impl: str = "xla", attn_impl: str = "xla"):
        super().__init__()
        im, token_dim = im_channels, im_channels * 2
        spatial = voxel_size // voxel_patch_stride
        self.iterations = iterations
        self.voxel_size, self.spatial = voxel_size, spatial
        self.low_dim_size = low_dim_size
        self.num_rotation_classes = num_rotation_classes
        self.num_collision_classes = num_collision_classes
        self.no_skip_connection, self.no_perceiver = no_skip_connection, no_perceiver
        self.no_language = no_language
        self.dtype = dtype

        self.encoder_3d = VoxelUNetShallow(initial_dim, im, unet_channels,
                                           dtype=dtype)
        self.patchify = Patchify3D(im, im, voxel_patch_size, activation,
                                   dtype=dtype)
        self.proprio_preprocess = (DenseBlock(low_dim_size, im, activation)
                                   if low_dim_size > 0 else None)
        self.lang_preprocess = Dense(lang_emb_dim, token_dim, dtype=dtype)
        self.pos_encoding = nn.Parameter(
            torch.empty(1, lang_max_seq_len + spatial ** 3, token_dim))
        self.latents = nn.Parameter(torch.empty(num_latents, latent_dim))

        self.cross_attn = PreNormAttention(latent_dim, cross_heads,
                                           cross_dim_head, context_dim=token_dim,
                                           dropout=input_dropout, dtype=dtype)
        self.cross_ff = PreNormFF(latent_dim, dtype=dtype)
        self.self_attn = nn.ModuleList(
            PreNormAttention(latent_dim, latent_heads, latent_dim_head,
                             dropout=attn_dropout, dtype=dtype, impl=attn_impl)
            for _ in range(depth))
        self.self_ff = nn.ModuleList(
            PreNormFF(latent_dim, dtype=dtype) for _ in range(depth))
        self.decoder_cross_attn = PreNormAttention(
            token_dim, cross_heads, cross_dim_head, context_dim=latent_dim,
            dropout=decoder_dropout, dtype=dtype)

        self.up0 = Conv3DUpsampleBlock(token_dim, final_dim, voxel_patch_stride,
                                       kernel_size=3, activation=activation,
                                       dtype=dtype, pad_mode=pad_mode,
                                       impl=conv_impl)
        final_in = (final_dim if no_skip_connection
                    else im if no_perceiver else im + final_dim)
        self.final = Conv3DBlock(final_in, im, 3, 1, activation, dtype=dtype,
                                 pad_mode=pad_mode, impl=conv_impl)
        self.trans_decoder = ChannelProjectConv3D(im, 1, 3, None, dtype=dtype,
                                                  pad_mode=pad_mode)
        if num_rotation_classes > 0:
            # spatial-softmax (3C) + max (C) summaries of d0, dec and lat
            feat_dim = 4 * im + 4 * token_dim + 4 * im
            self.dense0 = DenseBlock(feat_dim, 256, activation)
            self.dense1 = DenseBlock(256, final_dim, activation)
            self.rot_grip_collision_ff = DenseBlock(
                final_dim, num_rotation_classes * 3 + num_grip_classes
                + num_collision_classes, None)

    def init_params(self, generator: torch.Generator):
        init_weight_(self.pos_encoding, "normal", generator)
        init_weight_(self.latents, "normal", generator)

    def forward(self, voxel_grid, proprio, lang_goal_emb, lang_token_embs,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Rows] = None):
        """`rows`: this rank's place in a data-parallel global batch, for
        the dropout draws (None: the batch is the whole batch). The three
        stages are named ranges for torch.profiler: "policy/encoder" (the
        U-Net and its summaries), "policy/perceiver" (tokens, latents and
        the decoder cross-attention) and "policy/decoder" (the 100³
        upsample, `final` and the heads). Each holds ranges under its own
        name ("policy/perceiver/layer" once a self-attention layer), so
        that a trace can place every gap between the device's kernels."""
        b = voxel_grid.shape[0]
        drop = dict(deterministic=deterministic, generator=generator,
                    rows=rows)
        s = self.spatial

        with trace_annotation("policy/encoder"):
            d0, _ = self.encoder_3d(voxel_grid)                # [B,V,V,V,im]
            with trace_annotation("policy/encoder/summaries"):
                feats = list(spatial_softmax3d_with_max(d0))

        with trace_annotation("policy/perceiver"):
            with trace_annotation("policy/perceiver/tokens"):
                ins = self.patchify(d0)                        # [B,S,S,S,im]
                if self.proprio_preprocess is not None:
                    p = self.proprio_preprocess(proprio)       # [B,im] fp32
                    p = p[:, None, None, None, :].expand(b, s, s, s,
                                                         p.shape[-1])
                    ins = torch.cat([ins.float(), p], dim=-1)  # [B,S,S,S,2im]
                queries_shape = ins.shape
                ins = ins.reshape(b, s ** 3, ins.shape[-1])

                if self.no_language:
                    lang_token_embs = torch.zeros_like(lang_token_embs)
                lang = self.lang_preprocess(lang_token_embs)
                num_lang = lang.shape[1]
                ins = (torch.cat([lang.float(), ins.float()], dim=1)
                       + self.pos_encoding)

            x = self.latents[None].expand(b, *self.latents.shape)
            for _ in range(self.iterations):
                with trace_annotation("policy/perceiver/cross"):
                    x = self.cross_attn(x, context=ins, **drop) + x
                    x = self.cross_ff(x) + x
                for sa, ff in zip(self.self_attn, self.self_ff):
                    with trace_annotation("policy/perceiver/layer"):
                        x = sa(x, **drop) + x
                        x = ff(x) + x

            with trace_annotation("policy/perceiver/readout"):
                dec = self.decoder_cross_attn(ins, context=x,
                                              **drop)  # [B,S³+77,2im]
                dec = dec[:, num_lang:].reshape(queries_shape)
                feats.extend(spatial_softmax3d_with_max(dec))

        with trace_annotation("policy/decoder"):
            dt = self.dtype
            with trace_annotation("policy/decoder/volume"):
                up = self.up0(dec)                             # [B,V,V,V,fd]
                if self.no_skip_connection:
                    lat = self.final(up)
                elif self.no_perceiver:
                    lat = self.final(d0)
                else:
                    lat = self.final(torch.cat([d0.to(dt), up.to(dt)],
                                               dim=-1))
            with trace_annotation("policy/decoder/trans"):
                trans = self.trans_decoder(lat)                # [B,V,V,V,1]
            rot_grip_q = collision_q = None
            if self.num_rotation_classes > 0:
                with trace_annotation("policy/decoder/heads"):
                    feats.extend(spatial_softmax3d_with_max(lat))
                    h = self.dense0(torch.cat(feats, dim=1))
                    h = self.dense1(h)
                    out = self.rot_grip_collision_ff(h)
                    rot_grip_q = out[:, :-self.num_collision_classes]
                    collision_q = out[:, -self.num_collision_classes:]
        return trans, rot_grip_q, collision_q, d0, lang
