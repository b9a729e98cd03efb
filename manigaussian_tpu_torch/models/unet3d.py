"""Shallow 3D U-Net voxel encoder (port of `manigaussian_tpu/models/unet3d.py`,
the plain body at :58-79).

The JAX default `policy_unet_impl="packed"` runs the 100³/50³ stages
space-to-channel packed to fill the TPU's 128-lane tiles; it is the same
math (tests/test_packed3d.py pins it), so both impls map to this one body.
`convert.py` renames the packed parameters onto it.

Up stages resize with `nearest-exact`: `jax.image.resize(method="nearest")`
samples at half-pixel centers, which torch's `nearest` does not (it differs
on the odd 13→25 step).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from manigaussian_tpu_torch.models.blocks import (Conv3DBlock, ConvNormAct3D,
                                                  to_ncdhw, to_ndhwc)


def _resize_nearest(z: torch.Tensor, size: int) -> torch.Tensor:
    return to_ndhwc(F.interpolate(to_ncdhw(z), size=(size,) * 3,
                                  mode="nearest-exact"))


class VoxelUNetShallow(nn.Module):
    """[B, V, V, V, Cin] → ([B, V, V, V, out_channels] in `dtype`,
    [input, 25³ feats, 50³ feats]) with three stride-2 stages."""

    def __init__(self, in_channels: int = 10, out_channels: int = 128,
                 channels: Sequence[int] = (8, 16, 32, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.enc0 = ConvNormAct3D(in_channels, c[0], dtype=dtype)
        self.enc1_down = ConvNormAct3D(c[0], c[1], strides=2, dtype=dtype)
        self.enc1 = ConvNormAct3D(c[1], c[1], dtype=dtype)
        self.enc2_down = ConvNormAct3D(c[1], c[2], strides=2, dtype=dtype)
        self.enc2 = ConvNormAct3D(c[2], c[2], dtype=dtype)
        self.mid_down = ConvNormAct3D(c[2], c[3], strides=2, dtype=dtype)
        self.mid = ConvNormAct3D(c[3], c[3], dtype=dtype)
        # up stage = nearest resize, then conv + instance norm + lrelu(0.01)
        self.up2 = ConvNormAct3D(c[3], c[2], dtype=dtype)
        self.up1 = ConvNormAct3D(c[2], c[1], dtype=dtype)
        self.up0 = ConvNormAct3D(c[1], c[0], dtype=dtype)
        # 1×1 out conv in the compute dtype (d0 is emitted in `dtype`)
        self.out = Conv3DBlock(c[0], out_channels, kernel_size=1, dtype=dtype)

    def forward(self, x):
        voxel_list = [x]
        conv0 = self.enc0(x)                                       # V
        conv2 = self.enc1(self.enc1_down(conv0))                   # V/2
        conv4 = self.enc2(self.enc2_down(conv2))                   # V/4
        mid = self.mid(self.mid_down(conv4))                       # V/8 (ceil)
        x = conv4 + self.up2(_resize_nearest(mid, conv4.shape[1]))
        voxel_list.append(x)
        x = conv2 + self.up1(_resize_nearest(x, conv2.shape[1]))
        voxel_list.append(x)
        x = conv0 + self.up0(_resize_nearest(x, conv0.shape[1]))
        return self.out(x), voxel_list
