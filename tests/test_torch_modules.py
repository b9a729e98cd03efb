"""Smaller modules of the training slice against the JAX package on the CPU:
the spatial soft-argmax's hand-written gradient, the Gaussian regressor
(w_geo and with the deformation field), the losses and the SE(3)
augmentation with JAX's own draws fed to the port.

Tolerances: 1e-5 relative for fp32 values and gradients (the same formulas
summed in other orders); the regressor's gradients, sums over all points,
within 1e-5 (voxel features) and 1e-4 (parameters, through five 512-wide
residual blocks) of max(1, their largest magnitude); discrete outputs
(augmented action indices) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models.blocks import \
    spatial_softmax3d_with_max as j_softargmax
from manigaussian_tpu.models.gaussian_regressor import GeneralizableGSEmbedNet
from manigaussian_tpu.ops import augmentation as jaug
from manigaussian_tpu.ops import losses as jl
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.models import gaussian_regressor as tgr
from manigaussian_tpu_torch.models.blocks import \
    spatial_softmax3d_with_max as t_softargmax
from manigaussian_tpu_torch.ops import augmentation as taug
from manigaussian_tpu_torch.ops import losses as tl
from tests.torch_port_helpers import assert_close, random_flax_params, to_np


def assert_scaled(actual, expected, tol, err_msg=""):
    ref = to_np(expected)
    np.testing.assert_allclose(to_np(actual), ref, rtol=0, err_msg=err_msg,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def test_spatial_softmax_gradient_matches_jax():
    rng = np.random.default_rng(0)
    # quantized values: several grid cells tie for the max of a channel
    x = np.round(rng.standard_normal((2, 4, 5, 3, 6)) * 4) / 4
    x = x.astype(np.float32)
    g1 = rng.standard_normal((2, 18)).astype(np.float32)
    g2 = rng.standard_normal((2, 6)).astype(np.float32)

    def jloss(a):
        e, m = j_softargmax(a)
        return jnp.sum(e * g1) + jnp.sum(m * g2), (e, m)

    (_, (je, jm)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    te, tm = t_softargmax(tx)
    ((te * torch.from_numpy(g1)).sum() + (tm * torch.from_numpy(g2)).sum()).backward()
    assert_close(te, je, 1e-5)
    assert_close(tm, jm, 0)
    assert_close(tx.grad, jg, 1e-5)
    ties = (x.reshape(2, -1, 6) == x.reshape(2, -1, 6).max(1, keepdims=True)).sum(1)
    assert (ties > 1).any()


@pytest.mark.parametrize("dynamic", [False, True])
def test_gaussian_regressor_matches_jax(dynamic):
    rng = np.random.default_rng(1)
    b, n, v, dl = 2, 50, 8, 16
    xyz = (np.array([0.2, 0.0, 1.1]) + 0.2 * rng.standard_normal((b, n, 3))
           ).astype(np.float32)
    xyz[0, 0] = [2.0, 2.0, 2.0]                   # outside the grid: zeros
    feat = rng.standard_normal((b, v, v, v, dl)).astype(np.float32)
    action = rng.standard_normal((b, 8)).astype(np.float32)
    jm = GeneralizableGSEmbedNet(d_latent=dl, use_dynamic_field=dynamic)
    params = random_flax_params(jm, jnp.asarray(xyz), jnp.asarray(feat),
                                action=jnp.asarray(action), seed=2)
    tm = tgr.GeneralizableGSEmbedNet(d_latent=dl, use_dynamic_field=dynamic)
    sd = convert.renderer_state_dict({"gs_model": params["params"]})
    tm.load_state_dict({k[len("gs_model."):]: v for k, v in sd.items()})

    keys = ("xyz", "sh", "rot", "scale", "opacity", "feature")
    weights = {k: rng.standard_normal((b, n) + s).astype(np.float32)
               for k, s in zip(keys, ((3,), (4, 3), (4,), (3,), (1,), (3,)))}

    def loss_of(out, w, xp):
        total = sum(xp.sum(out[k] * w[k]) for k in keys)
        if dynamic:
            total = total + sum(xp.sum(out["next"][k] * w[k]) for k in keys)
        return total

    def jloss(p, f):
        out = jm.apply(p, jnp.asarray(xyz), f, action=jnp.asarray(action))
        aux = {k: out[k] for k in keys}            # plain dicts: pytrees
        if dynamic:
            aux["next"] = {k: out["next"][k] for k in keys}
        return loss_of(out, weights, jnp), aux

    (_, jout), (jgp, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_()
    tout = tm(torch.from_numpy(xyz), tf, action=torch.from_numpy(action))
    loss_of(tout, {k: torch.from_numpy(w) for k, w in weights.items()}, torch).backward()
    for k in keys:
        assert_close(tout[k], jout[k], 1e-5, err_msg=k)
        if dynamic:
            assert_close(tout["next"][k], jout["next"][k], 1e-5, err_msg="next " + k)
    assert_scaled(tf.grad, jgf, 1e-5)
    jgrads = convert.renderer_state_dict({"gs_model": jgp["params"]})
    for name, p in tm.named_parameters():
        assert_scaled(p.grad, jgrads["gs_model." + name], 1e-4, err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    a[0, 0, 0] = 0.0                              # an empty pixel: smooth norm
    logits = rng.standard_normal((3, 7)).astype(np.float32)
    idx = np.array([0, 6, 3], np.int32)
    pairs = [
        (tl.l2_loss, jl.l2_loss, (a, b)),
        (tl.cosine_loss, jl.cosine_loss, (a, b)),
        (tl.psnr, jl.psnr, (a, b)),
        (tl.psnr, jl.psnr, (a, a)),               # mse == 0 → 100
    ]
    for tf, jf, args in pairs:
        jv, jg = jax.value_and_grad(jf)(*(jnp.asarray(x) for x in args))
        tx = [torch.from_numpy(x).requires_grad_() for x in args]
        tv = tf(*tx)
        tv.backward()
        assert_close(tv, jv, 1e-5, err_msg=jf.__name__)
        assert_close(tx[0].grad, jg, 1e-5, err_msg=jf.__name__)
    jv, jg = jax.value_and_grad(jl.softmax_cross_entropy_with_index)(
        jnp.asarray(logits), jnp.asarray(idx))
    tx = torch.from_numpy(logits).requires_grad_()
    tv = tl.softmax_cross_entropy_with_index(tx, torch.from_numpy(idx))
    tv.backward()
    assert_close(tv, jv, 1e-6)
    assert_close(tx.grad, jg, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_augmentation_with_jax_draws_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b = 4
    bounds = np.array([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6], np.float32)
    pos = rng.uniform(bounds[:3], bounds[3:], (b, 3)).astype(np.float32)
    pos[0] = bounds[:3] + 0.01                    # near the floor: retries
    q = rng.standard_normal((b, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pose = np.concatenate([pos, q], -1)
    trans = rng.integers(0, 100, (b, 3)).astype(np.int32)
    rot_grip = rng.integers(0, 72, (b, 4)).astype(np.int32)
    pcd = rng.uniform(-0.5, 1.5, (b, 2, 6, 6, 3)).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    cams[..., :3, 3] = rng.standard_normal((b, 2, 3))
    key = jax.random.PRNGKey(seed)
    jout = jaug.apply_se3_augmentation(
        key, jnp.asarray(pcd), jnp.asarray(pose), jnp.asarray(trans),
        jnp.asarray(rot_grip), jnp.asarray(bounds), rot_aug_range=(0.0, 0.0, 45.0),
        camera_pose=jnp.asarray(cams))
    # the draws apply_se3_augmentation makes from `key`
    k_trans, k_rot = jax.random.split(key)
    u = jax.random.uniform(k_trans, (jaug.MAX_ATTEMPTS, b, 3), minval=-1.0, maxval=1.0)
    steps = jnp.asarray([0, 0, 9])
    rot = jax.random.randint(k_rot, (jaug.MAX_ATTEMPTS, b, 3), -steps, steps + 1)
    draws = taug.SE3Draws(torch.tensor(np.asarray(u)), torch.tensor(np.asarray(rot)))
    tout = taug.apply_se3_augmentation(
        draws, torch.from_numpy(pcd), torch.from_numpy(pose),
        torch.from_numpy(trans), torch.from_numpy(rot_grip),
        torch.from_numpy(bounds), camera_pose=torch.from_numpy(cams))
    np.testing.assert_array_equal(tout.action_trans.numpy(), np.asarray(jout.action_trans))
    np.testing.assert_array_equal(tout.action_rot_grip.numpy(),
                                  np.asarray(jout.action_rot_grip))
    assert_close(tout.pcd, jout.pcd, 1e-5)
    assert_close(tout.camera_pose, jout.camera_pose, 1e-5)


def test_sampled_draws_have_the_jax_ranges():
    d = taug.sample_se3_draws(torch.Generator().manual_seed(0), 64,
                              (0.0, 0.0, 45.0), 5.0)
    assert d.trans_unit.shape == (taug.MAX_ATTEMPTS, 64, 3)
    assert float(d.trans_unit.min()) >= -1.0 and float(d.trans_unit.max()) < 1.0
    assert int(d.rot_steps[..., :2].abs().max()) == 0
    assert set(d.rot_steps[..., 2].unique().tolist()) == set(range(-9, 10))
