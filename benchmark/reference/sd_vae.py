"""Stable-Diffusion VAE (CompVis AutoencoderKL) with the ODISE feature
taps, plain PyTorch: a frozen copy of the port's `models/sd_vae.py` without
the checkpoint loaders. The semantic tiers read the last decoder tap, a
[B, 512, H/4, W/4] feature (512² input → 128²): swish + GroupNorm(32, eps
1e-6) resnet blocks, the single-head mid attention, the stride-2
downsample after a (0, 1, 0, 1) pad, the nearest 2× upsample; the decoder
stops at its last tap. SD v1.x: ch 128, ch_mult (1, 2, 4, 4), 2 res blocks
a level, z 4 (double), scale_factor 0.18215.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import init_weight_

# flat res-block indices whose input the encoder / decoder return (ODISE)
ENCODER_TAPS = (5, 7)
DECODER_TAPS = (2, 5)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm(channels: int) -> nn.GroupNorm:
    """flax `GroupNorm(32, epsilon=1e-6)`."""
    return nn.GroupNorm(32, channels, eps=1e-6)


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """SAME padding for stride 1; VALID for the stride-2 downsample."""
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if stride == 1 else 0)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = group_norm(cin), conv(cin, cout, 3)
        self.norm2, self.conv2 = group_norm(cout), conv(cout, cout, 3)
        self.nin_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (the VAE's mid attention): plain
    matmul + softmax, the order of the JAX einsums."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = group_norm(c)
        self.q, self.k, self.v = conv(c, c, 1), conv(c, c, 1), conv(c, c, 1)
        self.proj_out = conv(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q = self.q(y).reshape(b, c, h * w).transpose(1, 2)      # [b, hw, c]
        k = self.k(y).reshape(b, c, h * w)                      # [b, c, hw]
        v = self.v(y).reshape(b, c, h * w).transpose(1, 2)      # [b, hw, c]
        root_c = torch.tensor(math.sqrt(float(c)), dtype=x.dtype,
                              device=x.device)
        attn = torch.softmax(torch.bmm(q, k) / root_c, dim=-1)
        out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution level: `block` (res blocks) and, where built,
    `downsample.conv` / `upsample.conv` (CompVis names)."""

    def __init__(self, blocks: Sequence[nn.Module], resample: Optional[str],
                 channels: int):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample == "down":
            self.downsample = nn.Module()
            self.downsample.conv = conv(channels, channels, 3, stride=2)
        elif resample == "up":
            self.upsample = nn.Module()
            self.upsample.conv = conv(channels, channels, 3)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1, self.attn_1 = ResnetBlock(c, c), AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class SDVaeEncoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4):
        super().__init__()
        self.conv_in = conv(3, ch, 3)
        levels, cin = [], ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            levels.append(_Level(blocks, "down" if i != len(ch_mult) - 1
                                 else None, cin))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(cin)
        self.norm_out = group_norm(cin)
        self.conv_out = conv(cin, 2 * z_channels, 3)

    def forward(self, x):
        """x [B, 3, H, W] in [-1, 1] → (moments [B, 2z, H/8, W/8], taps)."""
        feats, flat = [], 0
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                if flat in ENCODER_TAPS:
                    feats.append(h)
                h = block(h)
                flat += 1
            if hasattr(level, "downsample"):
                h = level.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h))), feats


class SDVaeDecoder(nn.Module):
    """The decoder up to its last tap. `up` is keyed by the CompVis level
    index; the levels past the last tap and the image head are not built."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = conv(z_channels, cin, 3)
        self.mid = _Mid(cin)
        self.up = nn.ModuleDict()
        self.order = []
        flat = 0
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cin, ch * ch_mult[i]))
                cin = ch * ch_mult[i]
                flat += 1
            last = flat > DECODER_TAPS[-1]
            self.up[str(i)] = _Level(blocks, None if last or i == 0 else "up",
                                     cin)
            self.order.append(str(i))
            if last:
                break

    def forward(self, z):
        """z [B, z, h, w] → the taps. It returns at the last tap: the block
        after it (built, as its parameters are in the JAX tree and the
        CompVis state dict) is not run, as XLA drops it from the JAX graph,
        whose output does not use it."""
        feats, flat = [], 0
        h = self.mid(self.conv_in(z))
        for key in self.order:
            level = self.up[key]
            for block in level.block:
                if flat in DECODER_TAPS:
                    feats.append(h)
                    if flat == DECODER_TAPS[-1]:
                        return feats
                h = block(h)
                flat += 1
            if hasattr(level, "upsample"):
                h = F.interpolate(h, scale_factor=2.0, mode="nearest-exact")
                h = level.upsample.conv(h)
        return feats


class SDVae(nn.Module):
    """encode (the posterior mean) → scaled latent → decoder taps."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4,
                 scale_factor: float = 0.18215):
        super().__init__()
        self.z_channels, self.scale_factor = z_channels, scale_factor
        self.encoder = SDVaeEncoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = conv(2 * z_channels, 2 * z_channels, 1)
        self.post_quant_conv = conv(z_channels, z_channels, 1)
        self.decoder = SDVaeDecoder(ch, ch_mult, num_res_blocks, z_channels)

    def forward(self, x: torch.Tensor) -> Dict:
        """x [B, 3, H, W] in [-1, 1] → {"latent", "encoder_features",
        "decoder_features"}, NCHW."""
        moments, enc_feats = self.encoder(x)
        mean = self.quant_conv(moments)[:, :self.z_channels]
        latent = self.scale_factor * mean
        z = self.post_quant_conv((1.0 / self.scale_factor) * latent)
        return {"latent": latent, "encoder_features": enc_feats,
                "decoder_features": self.decoder(z)}

    def init_params(self, generator: torch.Generator) -> "SDVae":
        """Random weights from `generator` (drawn on the CPU, so one seed
        gives one tower on any device): conv kernels flax's lecun_normal
        (std 1/√fan_in, truncated at ±2σ), biases 0, norms 1/0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    w = torch.empty(m.weight.shape)
                    m.weight.copy_(init_weight_(w, "lecun_normal", generator))
                    m.bias.zero_()
                elif isinstance(m, nn.GroupNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
        return self
