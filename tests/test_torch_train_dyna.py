"""The port's `w_geo_dyna` train step with `policy_conv_impl="pallas"` against
the JAX package on the CPU.

`update` on `micro_variant("w_geo_dyna")` in fp32, dropout 0, the dynamic
field's warm-up gate at step 1 (`next_mlp.warm_up=1`), from JAX parameters
converted one to one (a tree built with the 'pallas' conv keeps
`{kernel, bias}` flat; the deformation MLP sits in the renderer's subtree),
with JAX's own augmentation draws fed to the port: three steps of jitted JAX
`agent.update` and of the port's `update`, each port step from JAX's state
before it (`load_jax_train_state`, as in tests/test_torch_train.py), batch 2. Step 0 is before the
gate (one render; `dyna_loss` is logged against the zero image and stays out
of the total), steps 1-2 after it (two renders; `lambda_dyna · dyna_loss`
enters the total and the deformation field trains).

The JAX conv runs its Pallas kernels in interpret mode, the port its plain
versions. Tolerances as in tests/test_torch_train.py: every metric within
1e-4·max(1, |value|) step by step; parameters after the third LAMB step within
2e-5 + 1e-3 of their leaf's scale (but for the one leaf whose exact gradient
is zero, see NOISE_LEAF).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu import config as JC
from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from tests.test_torch_train import MICRO, jax_draws, make_batch
from tests.torch_port_helpers import (load_jax_train_state,
                                      random_flax_params, torch_config)

STEPS = 3
WARM_UP = 1
# the one bias shared by all logits of the translation softmax: its exact
# gradient is Σp − 1 = 0, so each package sees its own rounding noise
NOISE_LEAF = "qnet.trans_decoder.bias"


def micro_dyna_cfg():
    cfg = JC.micro_variant("w_geo_dyna")
    m = cfg.method
    nr = dataclasses.replace(m.neural_renderer, next_mlp=dataclasses.replace(
        m.neural_renderer.next_mlp, warm_up=WARM_UP))
    return dataclasses.replace(cfg, method=dataclasses.replace(
        m, input_dropout=0.0, attn_dropout=0.0, policy_conv_impl="pallas",
        neural_renderer=nr))


def make_dyna_batch():
    """The w_geo batch plus a next frame: its target view from a camera moved
    a little, and a non-zero action for the deformation field."""
    batch = make_batch()
    rng = np.random.default_rng(7)
    b = batch["rgb"].shape[0]
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = [0.02, -0.01, 0.0]
    batch["nerf_next_target_rgb"] = rng.uniform(
        size=batch["nerf_target_rgb"].shape).astype(np.float32)
    batch["nerf_next_target_pose"] = pose
    batch["nerf_next_target_intrinsic"] = batch["nerf_target_intrinsic"].copy()
    batch["action"] = (0.1 * rng.standard_normal((b, 8))).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def trajectories():
    cfg = micro_dyna_cfg()
    assert cfg.method.neural_renderer.use_dynamic_field
    jagent = JAgent(cfg)
    batch = make_dyna_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    nerf = {k: jb[k] for k in batch if k.startswith("nerf_")}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, action=jb["action"], seed=3, **nerf)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))

    state = TrainState(jnp.zeros((), jnp.int32), params, jagent.opt.init(params))
    update = jax.jit(jagent.update)
    jm, tm = [], []
    gen = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        key = jax.random.PRNGKey(20 + i)
        load_jax_train_state(tagent, state)
        state, metrics = update(state, jb, key)
        jm.append({k: float(v) for k, v in metrics.items()})
        out = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
        tm.append({k: float(v) for k, v in out.items()})
    return cfg, params, state, tagent, jm, tm


def test_jax_tree_with_the_pallas_conv_and_the_deformation_field_converts(
        trajectories):
    _, params, _, tagent, _, _ = trajectories
    q = params["params"]["qnet"]
    assert set(q["final"]) == {"kernel", "bias"}            # flat, no Conv_0
    assert set(q["up0"]["Conv3DBlock_1"]) == {"kernel", "bias"}
    assert "deformation" in params["params"]["neural_renderer"]["gs_model"]
    sd = convert.qfunction_state_dict(params)
    assert set(sd) == set(tagent.qfn.state_dict())
    assert any(k.startswith("neural_renderer.gs_model.deformation.") for k in sd)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(list(tagent.qfn.parameters())) == len(leaves)


@pytest.mark.parametrize("metric", ["total_loss", "rgb_loss", "dyna_loss",
                                    "bc_loss"])
def test_update_follows_jax_trajectory_across_the_gate(trajectories, metric):
    _, _, _, _, jm, tm = trajectories
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j)
        assert np.isfinite(t[metric])
        assert abs(t[metric] - j[metric]) <= 1e-4 * max(1.0, abs(j[metric])), (
            i, metric, t[metric], j[metric])


def test_dyna_loss_enters_the_total_only_after_the_gate(trajectories):
    cfg, _, _, _, jm, tm = trajectories
    m = cfg.method
    lam = m.neural_renderer.lambda_nerf
    for i, (j, t) in enumerate(zip(jm, tm)):
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), (i, k)
        assert t["dyna_loss"] > 0.0        # logged on both sides of the gate
        expect = m.lambda_bc * t["bc_loss"] + lam * (
            t["rgb_loss"] + (m.neural_renderer.lambda_dyna * t["dyna_loss"]
                             if i >= WARM_UP else 0.0))
        assert abs(t["total_loss"] - expect) <= 1e-5 * max(1.0, abs(expect)), i


def test_parameters_after_three_steps_match(trajectories):
    cfg, params, state, tagent, _, _ = trajectories
    expect = convert.qfunction_state_dict(jax.device_get(state.params))
    start = convert.qfunction_state_dict(params)
    got = tagent.qfn.state_dict()
    assert set(got) == set(expect)
    for k, v in expect.items():
        ref = v.numpy()
        if k == NOISE_LEAF:
            # LAMB moves a leaf by lr·‖w‖ a step whatever the gradient's size,
            # in the direction of its sign: here the sign of rounding noise
            w0 = np.abs(start[k].numpy()).max()
            for end in (got[k].numpy(), ref):
                assert np.abs(end - start[k].numpy()).max() \
                    <= 1.05 * STEPS * cfg.method.lr * w0
            continue
        tol = 2e-5 + 1e-3 * np.abs(ref).max()
        np.testing.assert_allclose(got[k].numpy(), ref, atol=tol, rtol=0,
                                   err_msg=k)
    # the deformation field trained once the gate opened
    moved = [k for k in expect
             if k.startswith("neural_renderer.gs_model.deformation.")
             and not torch.equal(got[k], start[k])]
    assert moved


def test_train_entry_point_dyna_pallas_on_the_cpu_with_resume(tmp_path):
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints
    demos, logs = str(tmp_path / "demos"), str(tmp_path / "logs")
    argv = ["--cpu", "--variant", "w_geo_dyna", "--demo-root", demos,
            "--logdir", logs, "--synthetic", *MICRO,
            "method.policy_conv_impl=pallas",
            "method.neural_renderer.next_mlp.warm_up=1"]
    first = train_cli.main([*argv, "framework.training_iterations=2"])[0]
    run = str(tmp_path / "logs" / "seed0")
    assert list_checkpoints(run) == [1]
    assert all(np.isfinite(v) for v in first.values())
    assert first["dyna_loss"] > 0.0
    with open(f"{run}/train_data.csv") as f:
        assert "dyna_loss" in f.readline().strip().split(",")
    second = train_cli.main([*argv, "framework.training_iterations=3",
                             "framework.load_existing_weights=true"])[0]
    assert list_checkpoints(run) == [1, 2]
    assert np.isfinite(second["total_loss"]) and second["dyna_loss"] > 0.0
