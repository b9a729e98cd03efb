"""Voxel-conditioned per-point Gaussian regressor and the action-conditioned
deformation field (port of `manigaussian_tpu/models/gaussian_regressor.py`,
with its helpers `models/positional.py`, `models/resnetfc.py` and
`ops/sampling.py`; reference `models_embed.py:21-307`, `resnetfc.py`,
`utils.py:133-176`).

world→canonical point mapping, trilinear sampling of the channels-last voxel
features (align_corners=True, zeros outside), 39-d positional encoding, a
ResnetFC backbone, softplus(β=100) → Linear, the parameter splits and their
activations. Kept for NaN-free gradients: `_safe_normalize`'s
sqrt(max(Σx², eps²)) and the clamp before the exp of the scale. Layer names
follow the flax modules (ResnetFC: `lin_in`, `lin_z`, `blocks`, `lin_out`
for flax's Dense_0, lin_z_i, block_i, Dense_1) so convert.py maps them one
to one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from manigaussian_tpu_torch.models.blocks import Dense
from manigaussian_tpu_torch.ops.camera import world_to_canonical
from manigaussian_tpu_torch.utils.device import constant

SPLIT_DIMS = (3, 1, 3, 4, 3, 3, 9)  # Δxyz, opacity, scale, rot, sh_dc, embed, sh_rest
MAX_SCALE = 0.05


def positional_encoding(x: torch.Tensor, num_freqs: int = 6,
                        freq_factor: float = 1.5) -> torch.Tensor:
    """[..., D] → [..., D + 2·F·D]: x first, then sin/cos interleaved per
    frequency (freq_factor · 2^i), as the reference PositionalEncoding."""
    lead, d = x.shape[:-1], x.shape[-1]
    freqs = freq_factor * (2.0 ** torch.arange(num_freqs, dtype=torch.float32,
                                               device=x.device))
    freqs = torch.repeat_interleave(freqs, 2)[None, :, None]          # [1,2F,1]
    phases = torch.zeros(2 * num_freqs, dtype=torch.float32, device=x.device)
    phases[1::2] = math.pi * 0.5
    flat = x.reshape(-1, d)
    embed = torch.sin(phases[None, :, None] + flat[:, None, :] * freqs)
    out = torch.cat([flat, embed.reshape(flat.shape[0], -1)], dim=-1)
    return out.reshape(*lead, out.shape[-1])


def trilinear_sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """volume [B, D0, D1, D2, C], coords [B, N, 3] in [-1, 1] (coords[..., i]
    indexes spatial axis i; align_corners=True) → [B, N, C] fp32; corners
    outside the grid count zero."""
    b = volume.shape[0]
    dims = constant(tuple(volume.shape[1:4]), torch.float32, volume.device)
    dims_i = dims.long()
    pix = (coords + 1.0) * 0.5 * (dims - 1.0)
    lo_f = torch.floor(pix)
    frac = pix - lo_f
    lo = lo_f.long()
    bidx = torch.arange(b, device=volume.device)[:, None]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                off = constant((dx, dy, dz), torch.int64, volume.device)
                corner = lo + off
                w = torch.where(off == 1, frac, 1.0 - frac).prod(dim=-1)
                inside = ((corner >= 0) & (corner < dims_i)).all(dim=-1)
                cc = torch.minimum(torch.clamp(corner, min=0), dims_i - 1)
                vals = volume[bidx, cc[..., 0], cc[..., 1], cc[..., 2]]
                out = out + torch.where(inside, w, torch.zeros_like(w))[..., None] * vals
    return out


def _act(beta: float):
    if beta > 0:
        return lambda x: F.softplus(beta * x) / beta
    return F.relu


class ResnetBlockFC(nn.Module):
    """x + fc1(act(fc0(act(x)))), fc1 zero-initialized (sizes equal here)."""

    def __init__(self, size: int, beta: float = 0.0):
        super().__init__()
        self.fc0 = Dense(size, size, init="kaiming_normal")
        self.fc1 = Dense(size, size, init="zeros")
        self.act = _act(beta)

    def forward(self, x):
        return x + self.fc1(self.act(self.fc0(self.act(x))))


class ResnetFC(nn.Module):
    """PixelNeRF-style FC ResNet with the latent z re-injected before each
    block < combine_layer. forward(zx [..., d_latent + d_in]) → [..., d_out]."""

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_latent: int = 0, d_hidden: int = 128, beta: float = 0.0,
                 combine_layer: int = 1000):
        super().__init__()
        self.d_latent = d_latent
        self.lin_in = Dense(d_in, d_hidden, init="kaiming_normal")
        n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_z = nn.ModuleList(Dense(d_latent, d_hidden, init="kaiming_normal")
                                   for _ in range(n_lin_z))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden, beta)
                                    for _ in range(n_blocks))
        self.lin_out = Dense(d_hidden, d_out, init="kaiming_normal")
        self.act = _act(beta)

    def forward(self, zx):
        z, x = zx[..., :self.d_latent], zx[..., self.d_latent:]
        x = self.lin_in(x)
        for i, block in enumerate(self.blocks):
            if i < len(self.lin_z):
                x = x + self.lin_z[i](z)
            x = block(x)
        return self.lin_out(self.act(x))


def _safe_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x/‖x‖ with a bounded, NaN-free gradient: sqrt(max(Σx², eps²))."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class GeneralizableGSEmbedNet(nn.Module):
    """forward(xyz [B,N,3], voxel_feat [B,V,V,V,d_latent], action [B,8])
    → dict xyz, sh [B,N,4,3], rot, scale, opacity [B,N,1], feature; with the
    dynamic field also ["next"], the deformed frame (inputs detached). With
    `use_semantic_feature` the deformation field also reads the detached
    embedding (3 channels, after the opacity)."""

    def __init__(self, coordinate_bounds=(-0.3, -0.5, 0.6, 0.7, 0.5, 1.6),
                 d_latent: int = 128, d_hidden: int = 512, n_blocks: int = 5,
                 combine_layer: int = 3, num_freqs: int = 6,
                 freq_factor: float = 1.5, use_dynamic_field: bool = False,
                 use_semantic_feature: bool = False, use_action: bool = True,
                 next_d_hidden: int = 512, next_n_blocks: int = 5):
        super().__init__()
        self.bounds = tuple(coordinate_bounds)
        self.num_freqs, self.freq_factor = num_freqs, freq_factor
        self.use_dynamic_field, self.use_action = use_dynamic_field, use_action
        self.use_semantic_feature = use_semantic_feature
        d_code = 3 + 6 * num_freqs
        d_out = sum(SPLIT_DIMS)
        self.encoder = ResnetFC(d_code, d_out, n_blocks, d_latent, d_hidden,
                                combine_layer=combine_layer)
        self.regresser = Dense(d_out, d_out)
        self.deformation = None
        if use_dynamic_field:
            # point_latent, xyz 3, sh_dc 3, sh_rest 9, rot 4, scale 3,
            # opacity 1, (embed 3,) z_feature, action 8
            d_in = (3 + 3 + 9 + 4 + 3 + 1 + (3 if use_semantic_feature else 0)
                    + d_code + (8 if use_action else 0))
            self.deformation = ResnetFC(d_in, 7, next_n_blocks, d_latent,
                                        next_d_hidden,
                                        combine_layer=combine_layer)

    def forward(self, xyz: torch.Tensor, voxel_feat: torch.Tensor,
                action: Optional[torch.Tensor] = None) -> Dict:
        b, n, _ = xyz.shape
        canon = world_to_canonical(xyz, self.bounds)
        point_latent = trilinear_sample(voxel_feat, canon * 2.0 - 1.0).float()
        z_feature = positional_encoding(canon, self.num_freqs, self.freq_factor)
        enc = self.encoder(torch.cat([point_latent, z_feature], dim=-1))
        raw = self.regresser(F.softplus(100.0 * enc) / 100.0)         # [B,N,26]
        d_xyz, opacity_raw, scale_raw, rot_raw, sh_dc, embed, sh_rest = \
            torch.split(raw, SPLIT_DIMS, dim=-1)
        sh = torch.cat([sh_dc[..., None, :], sh_rest.reshape(b, n, 3, 3)], dim=-2)
        rot = _safe_normalize(rot_raw)
        # clamp BEFORE exp: the backward of min(exp(x), c) is 0·inf = NaN once
        # exp overflows
        scale = torch.exp(torch.clamp(scale_raw, max=math.log(MAX_SCALE)))
        params = dict(xyz=xyz + d_xyz, sh=sh, rot=rot, scale=scale,
                      opacity=torch.sigmoid(opacity_raw), feature=embed)
        if self.deformation is not None:
            sg = torch.Tensor.detach
            pieces = [point_latent, sg(params["xyz"]), sg(sh_dc), sg(sh_rest),
                      sg(rot), sg(scale), sg(params["opacity"])]
            if self.use_semantic_feature:
                pieces.append(sg(embed))
            pieces.append(z_feature)
            if self.use_action and action is not None:
                pieces.append(action[:, None, :].expand(b, n, action.shape[-1]))
            delta = self.deformation(torch.cat(pieces, dim=-1))
            params["next"] = dict(
                xyz=sg(params["xyz"]) + delta[..., :3], sh=sg(sh),
                rot=_safe_normalize(sg(rot) + delta[..., 3:]), scale=sg(scale),
                opacity=sg(params["opacity"]), feature=sg(embed))
        return params
