"""The port's tile blend (manigaussian_tpu_torch/ops/blend.py) against the JAX
Pallas kernel `blend_tiles_pallas` (interpret mode on the CPU).

On the CPU `blend_tiles` runs its plain version, whose backward is autograd
of its forward; these cases hold both to the TPU kernel and its analytic VJP
on random tiles. Tolerances: the rules of the JAX golden tests
(`assert_mostly_close`): outputs atol 1e-4 / rtol 1e-3 with at most 0.5 % of
elements outside, gradients atol 2e-4 / rtol 1e-3 with at most 2 % outside.
The prefix sums run in another order (a cumulative sum against the TPU
kernel's triangular matmul), so a pixel whose transmittance sits on the
T < 1e-4 latch may flip, and a flip shifts the gradient of every splat
before it at that pixel. Also: `gather_splats`' segment-sum backward against the
JAX scatter-add, exactly up to fp32 reordering (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.pallas_blend import blend_tiles_pallas
from manigaussian_tpu.ops.pallas_blend import gather_splats as j_gather
from manigaussian_tpu_torch.ops.blend import (blend_forward, blend_tiles,
                                              gather_splats)
from tests.helpers import assert_mostly_close
from tests.test_torch_blend_gpu import random_tiles
from tests.torch_port_helpers import assert_close


@pytest.mark.parametrize("seed,k,chunk", [(0, 128, 32), (1, 256, 64),
                                          (2, 64, 32)])
def test_plain_blend_matches_pallas_fwd_and_vjp(seed, k, chunk):
    counts, origins, attrs, livet, grads = random_tiles(seed, k=k)
    cfg = (16, chunk, True)

    def jloss(a):
        out = blend_tiles_pallas(jnp.asarray(counts), jnp.asarray(origins), a,
                                 jnp.asarray(livet), 3, cfg)
        return sum(jnp.sum(o * g) for o, g in zip(out, grads)), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(attrs))
    ta = torch.from_numpy(attrs).requires_grad_()
    tout = blend_tiles(torch.from_numpy(counts), torch.from_numpy(origins), ta,
                       torch.from_numpy(livet), 3, 16, chunk)
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(tout, grads)).backward()
    for name, a, b in zip(("color", "lang", "log_t"), tout, jout):
        assert_mostly_close(a.detach().numpy(), np.asarray(b), atol=1e-4,
                            rtol=1e-3, err_msg=name)
    assert_mostly_close(ta.grad.numpy(), np.asarray(jgrad), atol=2e-4,
                        rtol=1e-3, max_frac=0.02, err_msg="dattrs")
    # latched pixels exist (the T < 1e-4 rule is exercised) at these densities
    assert (np.asarray(jout[2]) < np.log(1e-3)).any()


def test_wrapper_contract_on_the_cpu():
    counts, origins, attrs, livet, _ = random_tiles(3, k=64)
    args = [torch.from_numpy(x) for x in (counts, origins, attrs, livet)]
    before = blend_forward.launches
    blend_tiles(*args, 3, 16, 32)
    assert blend_forward.launches == before       # plain version: no launch
    with pytest.raises(ValueError):
        blend_forward(*args, 3, 16, 32)          # the kernel takes CUDA only
    with pytest.raises(ValueError):
        blend_tiles(*args, 3, 16, 48)            # K not a multiple of chunk


def test_gather_splats_backward_matches_jax_scatter():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((12, 50)).astype(np.float32)
    gidx = rng.integers(0, 50, size=(6, 40)).astype(np.int32)
    g = rng.standard_normal((12, 6, 40)).astype(np.float32)
    jgrad = jax.grad(lambda t: jnp.sum(j_gather(t, jnp.asarray(gidx)) * g))(
        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    out = gather_splats(tt, torch.from_numpy(gidx).long())
    assert_close(out, np.asarray(j_gather(jnp.asarray(table), jnp.asarray(gidx))), 0)
    (out * torch.from_numpy(g)).sum().backward()
    assert_close(tt.grad, np.asarray(jgrad), 1e-6)
