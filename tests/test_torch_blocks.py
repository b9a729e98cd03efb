"""The port's conv/dense blocks (manigaussian_tpu_torch/models/blocks.py)
against the JAX blocks, fp32, same numpy-drawn parameters through convert.py.

Tolerance 1e-5: the same fp32 math, summed in another order (conv
algorithms differ between XLA and torch). Both pad modes are covered, and
the two resize modes are pinned to jax.image.resize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models import blocks as JB
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.models import blocks as TB
from manigaussian_tpu_torch.models.unet3d import _resize_nearest
from tests.torch_port_helpers import assert_close, random_flax_params

TOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(jmod, tmod, x, state, seed=1):
    params = random_flax_params(jmod, jnp.asarray(x), seed=seed)
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x))
    tmod.load_state_dict(state(params["params"]))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    return out, ref


def _conv_block_state(tree):
    out = {}
    convert._conv_block(tree, "", out)
    return out


@pytest.mark.parametrize("impl,pad_mode,k,stride,act", [
    ("xla", "edge", 3, 1, "lrelu"),
    ("xla", "zero", 3, 1, None),
    ("z2d", "zero", 3, 1, "lrelu"),    # the fast-path tree {kernel, bias}
    ("z2d", "edge", 3, 1, "relu"),     # edge pad: z2d falls back to Conv_0
    ("xla", "zero", 3, 2, "lrelu"),
    ("xla", "edge", 1, 1, None),
])
def test_conv3d_block(impl, pad_mode, k, stride, act):
    x = _x((1, 7, 6, 5, 4))
    jm = JB.Conv3DBlock(6, k, stride, act, pad_mode=pad_mode, impl=impl)
    tm = TB.Conv3DBlock(4, 6, k, stride, act, pad_mode=pad_mode, impl=impl)
    out, ref = _run(jm, tm, x, _conv_block_state)
    assert_close(out, ref, TOL)


def test_patchify3d():
    x = _x((1, 10, 10, 5, 3))
    jm = JB.Patchify3D(8, 5, "lrelu")
    tm = TB.Patchify3D(3, 8, 5, "lrelu")
    out, ref = _run(jm, tm, x, lambda t: {"weight": convert._conv(t["kernel"]),
                                          "bias": torch.from_numpy(t["bias"])})
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
def test_channel_project_conv3d(pad_mode):
    x = _x((1, 6, 5, 4, 8))
    jm = JB.ChannelProjectConv3D(1, 3, None, pad_mode=pad_mode)
    tm = TB.ChannelProjectConv3D(8, 1, 3, None, pad_mode=pad_mode)
    out, ref = _run(jm, tm, x, lambda t: {"weight": convert._conv(t["kernel"]),
                                          "bias": torch.from_numpy(t["bias"])})
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("act,norm,scale", [
    ("lrelu", None, 1.0), (None, None, 1.0), ("gelu", "layer", 1.0),
    ("tanh", None, 1.0), (None, "layer", 1e-3)])   # 1e-3: eps decides
def test_dense_block(act, norm, scale):
    x = _x((3, 12)) * scale

    def state(t):
        out = {}
        convert._dense(t["Dense_0"], "dense.", out)
        if "LayerNorm_0" in t:
            convert._norm(t["LayerNorm_0"], "norm.", out)
        return out

    out, ref = _run(JB.DenseBlock(7, act, norm), TB.DenseBlock(12, 7, act, norm),
                    x, state)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("stride,scale", [(1, 1.0), (2, 1.0), (1, 1e-3)])
def test_conv_norm_act3d(stride, scale):
    """scale 1e-3 makes the variance ~1e-6, where flax's eps (1e-6, not
    torch's 1e-5) decides the output."""
    x = _x((1, 9, 8, 7, 5)) * scale

    def state(t):
        out = {}
        convert._conv_norm(t, "", out)
        return out

    out, ref = _run(JB.ConvNormAct3D(6, strides=stride),
                    TB.ConvNormAct3D(5, 6, strides=stride), x, state)
    assert_close(out, ref, TOL)


def test_spatial_softmax3d_with_max():
    x = _x((2, 6, 5, 4, 3)) * 0.05   # temperature 0.01: scores of order 5
    ref_soft, ref_max = JB.spatial_softmax3d_with_max(jnp.asarray(x))
    soft, mx = TB.spatial_softmax3d_with_max(torch.from_numpy(x))
    assert_close(soft, ref_soft, TOL)
    assert_close(mx, ref_max, 0.0)


@pytest.mark.parametrize("impl,pad_mode", [("z2d", "zero"), ("xla", "edge")])
def test_conv3d_upsample_block(impl, pad_mode):
    x = _x((1, 3, 2, 4, 6))
    jm = JB.Conv3DUpsampleBlock(5, 5, 3, "lrelu", pad_mode=pad_mode, impl=impl)
    tm = TB.Conv3DUpsampleBlock(6, 5, 5, 3, "lrelu", pad_mode=pad_mode,
                                impl=impl)

    def state(t):
        out = {}
        convert._conv_block(t["Conv3DBlock_0"], "conv_a.", out)
        convert._conv_block(t["Conv3DBlock_1"], "conv_b.", out)
        return out

    out, ref = _run(jm, tm, x, state)
    assert out.shape == (1, 15, 10, 20, 5)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("src,dst", [(3, 5), (13, 25), (25, 50), (50, 100)])
def test_nearest_resize_is_half_pixel(src, dst):
    """jax.image.resize "nearest" samples half-pixel centers: torch's
    `nearest-exact`, not `nearest` (they differ on 13→25)."""
    x = _x((1, src, src, src, 2))
    ref = jax.image.resize(jnp.asarray(x), (1, dst, dst, dst, 2), "nearest")
    assert_close(_resize_nearest(torch.from_numpy(x), dst), ref, 0.0)


@pytest.mark.parametrize("name", ["relu", "lrelu", "elu", "tanh", "gelu", None])
def test_act_layer(name):
    x = _x((64,)) * 3
    assert_close(TB.act_layer(name)(torch.from_numpy(x)),
                 JB.act_layer(name)(jnp.asarray(x)), 1e-6)
