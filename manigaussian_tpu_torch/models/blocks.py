"""Building blocks of the voxel policy network.

Port of `manigaussian_tpu/models/blocks.py`. Public layouts
stay channels-last ([B, D, H, W, C]), as in the JAX package; a module
transposes to NCDHW only around `F.conv3d`, and that transpose of a
contiguous channels-last tensor is a `channels_last_3d` view, so no copy.

Compute-dtype convention (MethodConfig.policy_dtype), as in the JAX package:
parameters stay float32; `dtype` is the compute type of the linear and conv
products only (inputs and weights are cast to it); norms, softmaxes and the
heads run in float32.

Parity traps, each matched here:
  * Flax LayerNorm/GroupNorm use eps 1e-6 (torch's default is 1e-5); the
    instance norm is GroupNorm(C, C);
  * the leaky-ReLU slope is 0.02 in `act_layer` but 0.01 in ConvNormAct3D
    and the U-Net's up stages;
  * `jax.nn.gelu` is the tanh approximation;
  * `jax.image.resize(..., "trilinear")` is `F.interpolate(mode="trilinear",
    align_corners=False)` when upsampling by an integer factor.

Parameters are created empty; `initialize(module, generator)` fills every
module of this package with the JAX package's initializers, drawing from an
explicit `torch.Generator` (on the CPU, so a seed gives the same weights on
any device).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.02  # network_utils.py:14
NORM_EPS = 1e-6     # flax.linen LayerNorm / GroupNorm default


def act_layer(name: Optional[str]):
    if name is None:
        return lambda x: x
    return {
        "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, LRELU_SLOPE),
        "elu": F.elu,
        "tanh": torch.tanh,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def init_kind(activation: Optional[str]) -> str:
    """The reference init policy (blocks._kaiming_or_xavier): kaiming for
    relu/lrelu, xavier otherwise."""
    if activation == "relu":
        return "kaiming_uniform"
    if activation == "lrelu":
        return "lrelu_uniform"
    return "xavier_uniform"


def _fans(w: torch.Tensor):
    """(fan_in, fan_out) of a Linear [out, in] or conv [out, in, *k] weight,
    counted as flax counts them on its [*k, in, out] kernels."""
    receptive = math.prod(w.shape[2:]) if w.ndim > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def init_weight_(w: torch.Tensor, kind: str, generator: torch.Generator):
    """flax.linen initializers by name, in place, from `generator`."""
    fan_in, fan_out = _fans(w)
    with torch.no_grad():
        if kind in ("lecun_normal", "kaiming_normal"):
            # variance_scaling(1 or 2, fan_in, truncated_normal): ±2σ
            scale = 1.0 if kind == "lecun_normal" else 2.0
            std = math.sqrt(scale / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            return w
        if kind == "zeros":
            return w.zero_()
        if kind == "normal":
            return w.normal_(0.0, 1.0, generator=generator)
        scale, fan = {"kaiming_uniform": (2.0, fan_in),
                      "lrelu_uniform": (2.0 / (1 + LRELU_SLOPE ** 2), fan_in),
                      "xavier_uniform": (1.0, (fan_in + fan_out) / 2)}[kind]
        limit = math.sqrt(3.0 * scale / fan)
        return w.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """flax `nn.Dense`: weight [out, in] (the transpose of flax's kernel),
    product in `dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 init: str = "lecun_normal"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)
        self.dtype = dtype
        self.init = init

    def init_params(self, generator: torch.Generator):
        init_weight_(self.weight, self.init, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=NORM_EPS)


def initialize(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` from `generator`: the modules of this
    package by their own `init_params`, torch norms to ones/zeros."""
    for m in module.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
    return module


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def pad3d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the three spatial dims of a channels-last volume; mode 'edge'
    (jnp.pad's name for replicate) or 'zero'."""
    if mode == "edge":
        return to_ndhwc(F.pad(to_ncdhw(x), (pad,) * 6, mode="replicate"))
    return F.pad(x, (0, 0) + (pad,) * 6)


class Conv3DBlock(nn.Module):
    """k³ conv + optional activation (JAX blocks.py:55-116).

    The JAX block has three impls of the 3³ stride-1 zero-pad conv ('xla',
    'z2d', 'pallas'); 'xla' and 'z2d' are the same math and both become
    `F.conv3d` here. The explicit impls accumulate in float32 and add the
    float32 bias before casting to `dtype`; 'xla' adds the bias in `dtype`,
    and that difference in rounding is kept.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, strides: int = 1,
                 activation: Optional[str] = None,
                 padding: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, pad_mode: str = "edge",
                 impl: str = "xla"):
        super().__init__()
        if impl == "pallas":
            raise NotImplementedError(
                "policy_conv_impl='pallas' (the TPU conv kernel) is not "
                "ported yet; use 'z2d' or 'xla'")
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.kernel_size, self.strides = k, strides
        self.pad = k // 2 if padding is None else padding
        self.activation = activation
        self.dtype, self.pad_mode, self.impl = dtype, pad_mode, impl

    def init_params(self, generator: torch.Generator):
        init_weight_(self.weight, init_kind(self.activation), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):  # [B, D, H, W, C]
        dt, pad = self.dtype, self.pad
        act = act_layer(self.activation)
        w = self.weight.to(dt)
        fast = (self.impl != "xla" and self.kernel_size == 3
                and self.strides == 1 and pad == 1 and self.pad_mode != "edge")
        if fast:
            y = F.conv3d(to_ncdhw(x.to(dt)), w, padding=1).float()
            y = act(y + self.bias[:, None, None, None]).to(dt)
            return to_ndhwc(y)
        conv_pad = pad
        if pad > 0 and self.pad_mode == "edge":
            x = pad3d(x, pad, "edge")
            conv_pad = 0
        y = F.conv3d(to_ncdhw(x.to(dt)), w, self.bias.to(dt),
                     stride=self.strides, padding=conv_pad)
        return to_ndhwc(act(y))


class Patchify3D(nn.Module):
    """Non-overlapping p³ patch embedding as reshape + one matmul (JAX
    blocks.py:141-174), with the same reshape/transpose order, so the
    contraction runs over (pd, ph, pw, c) exactly as the JAX one does."""

    def __init__(self, in_channels: int, out_channels: int, patch: int,
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = patch
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, p, p, p))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.patch, self.activation, self.dtype = patch, activation, dtype

    def init_params(self, generator: torch.Generator):
        init_weight_(self.weight, init_kind(self.activation), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):  # [B, D, H, W, C], D/H/W % patch == 0
        b, d, h, w, c = x.shape
        p, dt = self.patch, self.dtype
        xd = x.to(dt).reshape(b, d // p, p, h // p, p, w // p, p, c)
        xd = xd.permute(0, 1, 3, 5, 2, 4, 6, 7)          # [B,S,S,S,p,p,p,C]
        xd = xd.reshape(b, d // p, h // p, w // p, p * p * p * c)
        wd = self.weight.to(dt).permute(2, 3, 4, 1, 0).reshape(
            p * p * p * c, -1)                           # flax [p,p,p,C,O]
        y = torch.matmul(xd, wd) + self.bias.to(dt)
        return act_layer(self.activation)(y)


class ChannelProjectConv3D(nn.Module):
    """k³ conv with few output channels (the trans Q-head, 128→1) as a
    channel-contraction matmul + k³ shifted adds (JAX blocks.py:177-216);
    contraction inputs in `dtype`, accumulation and output float32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, pad_mode: str = "edge"):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.kernel_size, self.activation = k, activation
        self.dtype, self.pad_mode = dtype, pad_mode

    def init_params(self, generator: torch.Generator):
        init_weight_(self.weight, init_kind(self.activation), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):  # [B, D, H, W, C]
        b, d, h, w, c = x.shape
        k, co = self.kernel_size, self.weight.shape[0]
        xp = pad3d(x, k // 2, self.pad_mode).to(self.dtype)
        # flax kernel [k,k,k,C,Co] → [C, k³·Co]; the product of two values of
        # `dtype` is exact in float32, so a float32 matmul of the cast
        # operands is the JAX dot with preferred_element_type=float32
        wd = self.weight.to(self.dtype).permute(1, 2, 3, 4, 0).reshape(c, -1)
        y = torch.matmul(xp.float(), wd.float())        # [B,D+2p,..,k³·Co]
        out = torch.zeros(b, d, h, w, co, dtype=torch.float32, device=x.device)
        for oi in range(k):
            for oj in range(k):
                for ok in range(k):
                    o = (oi * k + oj) * k + ok
                    out = out + y[:, oi:oi + d, oj:oj + h, ok:ok + w,
                                  o * co:(o + 1) * co]
        return act_layer(self.activation)(out + self.bias)


class DenseBlock(nn.Module):
    """Linear + optional norm/activation (JAX blocks.py:219-233)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: Optional[str] = None, norm: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(in_features, out_features, dtype=dtype,
                           init=init_kind(activation))
        self.norm = layer_norm(out_features) if norm == "layer" else None
        self.activation = activation

    def forward(self, x):
        x = self.dense(x)
        if self.norm is not None:
            x = self.norm(x)
        return act_layer(self.activation)(x)


class ConvNormAct3D(nn.Module):
    """conv (no bias) + instance norm + leaky_relu(0.01) (JAX
    blocks.py:236-252); the norm runs in float32 on the conv's output."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, k))
        self.norm = nn.GroupNorm(out_channels, out_channels, eps=NORM_EPS)
        self.strides, self.dtype = strides, dtype

    def init_params(self, generator: torch.Generator):
        init_weight_(self.weight, "lecun_normal", generator)

    def forward(self, x):  # [B, D, H, W, C]
        y = F.conv3d(to_ncdhw(x.to(self.dtype)), self.weight.to(self.dtype),
                     stride=self.strides, padding=self.weight.shape[-1] // 2)
        y = self.norm(y.float())
        return to_ndhwc(F.leaky_relu(y, 0.01))


def _pos_grid(d: int, h: int, w: int, device) -> torch.Tensor:
    """[-1, 1]³ coordinate grid, row-major over (d, h, w) → [P, 3]."""
    axes = [torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
            for n in (d, h, w)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


class _SoftArgmaxMax(torch.autograd.Function):
    """Soft-argmax and max over the grid axis of xf [B, P, C] (JAX
    blocks.py:264-317, an XLA custom VJP). The backward recomputes the
    softmax weights instead of saving the [B, P, C] attention tensor, and
    splits the max's cotangent equally over argmax ties (what jnp.max's
    autodiff gives)."""

    @staticmethod
    def forward(ctx, xf, pos, temperature):
        t = torch.tensor(temperature, dtype=torch.float32, device=xf.device)
        z = xf.float() / t
        m = z.amax(dim=1, keepdim=True)
        xmax = xf.amax(dim=1).float()
        e = torch.exp(z - m)
        s0 = e.sum(dim=1)                                   # [B, C]
        out = torch.einsum("bpc,pk->bck", e, pos) / s0[..., None]
        ctx.save_for_backward(xf, pos, m, s0, out, xmax)
        ctx.temperature = t
        return out, xmax

    @staticmethod
    def backward(ctx, g_out, g_max):
        xf, pos, m, s0, out, xmax = ctx.saved_tensors
        t = ctx.temperature
        z = xf.float() / t
        dx = torch.zeros_like(z)
        if g_out is not None:
            attn = torch.exp(z - m) / s0[:, None, :]
            proj = torch.einsum("pk,bck->bpc", pos, g_out)
            dot = (out * g_out).sum(dim=-1)
            dx = attn * (proj - dot[:, None, :]) / t
        if g_max is not None:
            tie = (xf.float() == xmax[:, None, :]).float()
            dx = dx + tie * (g_max[:, None, :] / tie.sum(dim=1, keepdim=True))
        return dx.to(xf.dtype), None, None


def spatial_softmax3d_with_max(x: torch.Tensor, temperature: float = 0.01):
    """Per-channel soft-argmax + per-channel max over a 3D grid (JAX
    blocks.py:255-335): returns (expected coordinates [B, C*3], max [B, C]),
    both float32. The division by the temperature is by a tensor, as a true
    division (see ops/voxelize.py)."""
    b, d, h, w, c = x.shape
    out, xmax = _SoftArgmaxMax.apply(x.reshape(b, d * h * w, c),
                                     _pos_grid(d, h, w, x.device), temperature)
    return out.reshape(b, c * 3), xmax


class Conv3DUpsampleBlock(nn.Module):
    """conv → trilinear resize ×stride → conv (JAX blocks.py:353-381); `impl`
    applies to the post-resize conv only."""

    def __init__(self, in_channels: int, out_channels: int, strides: int,
                 kernel_size: int = 3, activation: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, pad_mode: str = "edge",
                 impl: str = "xla"):
        super().__init__()
        self.conv_a = Conv3DBlock(in_channels, out_channels, kernel_size, 1,
                                  activation, dtype=dtype, pad_mode=pad_mode)
        self.conv_b = Conv3DBlock(out_channels, out_channels, kernel_size, 1,
                                  activation, dtype=dtype, pad_mode=pad_mode,
                                  impl=impl)
        self.strides = strides

    def forward(self, x):
        x = self.conv_a(x)
        if self.strides > 1:
            _, d, h, w, _ = x.shape
            s = self.strides
            x = to_ndhwc(F.interpolate(to_ncdhw(x), size=(d * s, h * s, w * s),
                                       mode="trilinear", align_corners=False))
        return self.conv_b(x)
