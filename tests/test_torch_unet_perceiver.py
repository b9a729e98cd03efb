"""The port's U-Net and Perceiver against the JAX modules, fp32, with the JAX
parameters carried over by convert.py.

The JAX U-Net's default impl is 'packed' (space-to-channel packing of the
100³/50³ stages); the port runs the plain body, which is the same math, so
both JAX impls are held to it. The Perceiver runs at the tiny config of
tests/test_agent.py with attn_impl='flash' (the JAX side through the Pallas
kernel in interpret mode). Tolerance 1e-4: fp32 throughout, but the 20³
convs and the attention sums run in another order, over a dozen layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models.perceiver import \
    PerceiverVoxelLangEncoder as JPerceiver
from manigaussian_tpu.models.unet3d import VoxelUNetShallow as JUNet
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.models.perceiver import \
    PerceiverVoxelLangEncoder as TPerceiver
from manigaussian_tpu_torch.models.unet3d import VoxelUNetShallow as TUNet
from tests.torch_port_helpers import assert_close, random_flax_params

TOL = 1e-4


@pytest.mark.parametrize("impl", ["packed", "xla"])
def test_unet_matches_jax(impl):
    x = np.random.default_rng(0).standard_normal((1, 20, 20, 20, 10)).astype(
        np.float32)
    jm = JUNet(out_channels=16, impl=impl)
    params = random_flax_params(jm, jnp.asarray(x), seed=1)
    ref, ref_list = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = TUNet(10, 16)
    tm.load_state_dict(convert.unet_state_dict(params["params"]))
    with torch.no_grad():
        out, out_list = tm(torch.from_numpy(x))
    assert_close(out, ref, TOL)
    for a, b in zip(out_list, ref_list):
        assert_close(a, b, TOL)


def _perceiver_kwargs(pad_mode, conv_impl):
    # tests/test_agent.py tiny_config through QFunction._perceiver's mapping
    return dict(depth=1, voxel_size=20, initial_dim=10, low_dim_size=4,
                num_rotation_classes=72, num_latents=32, im_channels=16,
                latent_dim=32, cross_dim_head=8, latent_dim_head=8,
                final_dim=16, pad_mode=pad_mode, conv_impl=conv_impl,
                attn_impl="flash")


@pytest.mark.parametrize("pad_mode,conv_impl", [("zero", "z2d"),
                                                ("edge", "xla")])
def test_perceiver_matches_jax(pad_mode, conv_impl):
    rng = np.random.default_rng(2)
    vox = (rng.standard_normal((1, 20, 20, 20, 10)) * 0.5).astype(np.float32)
    proprio = rng.standard_normal((1, 4)).astype(np.float32)
    goal = rng.standard_normal((1, 1024)).astype(np.float32)
    toks = (rng.standard_normal((1, 77, 512)) * 0.1).astype(np.float32)
    inputs = (vox, proprio, goal, toks)

    kw = _perceiver_kwargs(pad_mode, conv_impl)
    jm = JPerceiver(unet_impl="packed", **kw)
    params = random_flax_params(jm, *map(jnp.asarray, inputs), seed=3)
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, inputs))

    tm = TPerceiver(**kw)
    tm.load_state_dict(convert.perceiver_state_dict(params["params"]))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, inputs))
    for name, a, b in zip(("trans", "rot_grip", "collision", "d0", "lang"),
                          out, ref):
        assert a.shape == b.shape, name
        assert_close(a, b, TOL, err_msg=name)


def test_perceiver_bf16_dtype_flow_matches_jax():
    """policy_dtype bf16: the same outputs come out in the same types as in
    JAX (heads float32, d0 and the language tokens bf16), and the values agree
    to a few bf16 steps of their scale — the two packages round at different
    points (the JAX z2d conv rounds each of its three partial sums, a torch
    conv once), so the bound is 5e-2 × max(1, max|ref|), as chip_smoke.py
    uses between its two attention routes."""
    rng = np.random.default_rng(5)
    inputs = ((rng.standard_normal((1, 20, 20, 20, 10)) * 0.5).astype(np.float32),
              rng.standard_normal((1, 4)).astype(np.float32),
              rng.standard_normal((1, 1024)).astype(np.float32),
              (rng.standard_normal((1, 77, 512)) * 0.1).astype(np.float32))
    kw = _perceiver_kwargs("zero", "z2d")
    jm = JPerceiver(unet_impl="packed", dtype=jnp.bfloat16, **kw)
    params = random_flax_params(jm, *map(jnp.asarray, inputs), seed=6)
    ref = jax.jit(jm.apply)(params, *map(jnp.asarray, inputs))
    tm = TPerceiver(dtype=torch.bfloat16, **kw)
    tm.load_state_dict(convert.perceiver_state_dict(params["params"]))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, inputs))
    for name, a, b in zip(("trans", "rot_grip", "collision", "d0", "lang"),
                          out, ref):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        b32 = np.asarray(b, np.float32)
        assert_close(a, b32, 5e-2 * max(1.0, float(np.abs(b32).max())),
                     err_msg=name)
