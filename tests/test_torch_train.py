"""The port's train step against the JAX package on the CPU.

`update` on `micro_variant("w_geo")` in fp32 with dropout 0, from JAX
parameters converted one to one, with JAX's own augmentation draws fed to
the port: three steps of jitted JAX `agent.update` and of the port's
`update`, batch 2 (two views render as one problem of 2·T tiles).

Tolerances: every metric within 1e-4·max(1, |value|), step by step (fp32
through the policy, the renderer and the blend, summed in other orders;
measured ≤ 3e-5 over the three steps); parameters
after three LAMB steps within 2e-5 + 1e-3 relative of their leaf's scale
(LAMB normalizes each leaf's step, so a leaf moves by about lr·‖w‖ per step
whatever the gradient's size, and a gradient entry near 0 may change sign
between the two sums). Also: the parameter partition equals the flax tree
leaf for leaf (LAMB's trust ratio is per leaf), and LAMB with the clip
against `lamb_reference` over 3 steps on the same gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manigaussian_tpu import config as JC
from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu.ops.augmentation import MAX_ATTEMPTS
from manigaussian_tpu.utils.optimizers import lamb_reference
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from manigaussian_tpu_torch.ops.augmentation import SE3Draws
from manigaussian_tpu_torch.utils.optimizers import Lamb
from tests.torch_port_helpers import random_flax_params, torch_config

STEPS = 3


def micro_cfg():
    cfg = JC.micro_variant("w_geo")
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, input_dropout=0.0, attn_dropout=0.0))


def make_batch(seed=0, b=2, h=32, w=32, img=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    pose = np.eye(4, dtype=f)
    return {
        "rgb": rng.uniform(size=(b, 1, h, w, 3)).astype(f),
        # spread over the view, so that no tile overflows the micro
        # config's capacity (an overflow drops a depth-ranked tail, whose
        # edge can move with one splat's rect between two summation orders)
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((b, 1, h, w, 3))).astype(f),
        "low_dim_state": np.zeros((b, 4), f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": np.array([[10, 9, 11]] * b, np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]] * b, np.int32),
        "ignore_collisions": np.ones((b, 1), np.int32),
        "gripper_pose": np.tile(np.array([0.2, 0, 1.1, 0, 0, 0, 1.0], f), (b, 1)),
        "action": np.zeros((b, 8), f),
        "camera_extrinsics": np.tile(np.eye(4, dtype=f), (b, 1, 1, 1)),
        "nerf_target_rgb": rng.uniform(size=(b, img, img, 3)).astype(f),
        "nerf_target_pose": np.tile(pose, (b, 1, 1)),
        "nerf_target_intrinsic": np.tile(intr, (b, 1, 1)),
    }


def jax_draws(cfg, key, b):
    """The augmentation draws JAX's `update` makes from `key`."""
    m = cfg.method
    key_aug, _ = jax.random.split(key)
    k_trans, k_rot = jax.random.split(key_aug)
    u = jax.random.uniform(k_trans, (MAX_ATTEMPTS, b, 3), minval=-1.0, maxval=1.0)
    steps = jnp.asarray([int(r // m.rotation_resolution) for r in m.aug_rpy])
    rot = jax.random.randint(k_rot, (MAX_ATTEMPTS, b, 3), -steps, steps + 1)
    return SE3Draws(torch.from_numpy(np.asarray(u)),
                    torch.from_numpy(np.asarray(rot)))


@pytest.fixture(scope="module")
def trajectories():
    cfg = micro_cfg()
    jagent = JAgent(cfg)
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, nerf_target_rgb=jb["nerf_target_rgb"],
        nerf_target_pose=jb["nerf_target_pose"],
        nerf_target_intrinsic=jb["nerf_target_intrinsic"],
        action=jb["action"], seed=3)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))

    state = TrainState(jnp.zeros((), jnp.int32), params, jagent.opt.init(params))
    update = jax.jit(jagent.update)
    jm, tm = [], []
    gen = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        key = jax.random.PRNGKey(10 + i)
        state, metrics = update(state, jb, key)
        jm.append({k: float(v) for k, v in metrics.items()})
        out = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
        tm.append({k: float(v) for k, v in out.items()})
    return cfg, params, state, tagent, jm, tm


def test_update_follows_jax_loss_trajectory(trajectories):
    _, _, _, _, jm, tm = trajectories
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j)
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), (i, k, t[k], j[k])
    assert all(np.isfinite(v) for m in tm for v in m.values())
    assert tm[0]["total_loss"] != tm[-1]["total_loss"]


def test_parameters_after_three_steps_match(trajectories):
    _, _, state, tagent, _, _ = trajectories
    expect = convert.qfunction_state_dict(jax.device_get(state.params))
    got = tagent.qfn.state_dict()
    assert set(got) == set(expect)
    for k, v in expect.items():
        ref = v.numpy()
        tol = 2e-5 + 1e-3 * np.abs(ref).max()
        np.testing.assert_allclose(got[k].numpy(), ref, atol=tol, rtol=0,
                                   err_msg=k)


def test_parameter_partition_equals_the_flax_tree(trajectories):
    _, params, _, tagent, _, _ = trajectories
    leaves = jax.tree_util.tree_leaves(params)
    tparams = list(tagent.qfn.parameters())
    assert len(tparams) == len(leaves)
    assert sorted(p.numel() for p in tparams) == sorted(int(np.size(x)) for x in leaves)


def test_lamb_and_clip_match_lamb_reference():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2), (4,)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ps[3][:] = 0.0                                 # a zero leaf: trust 1
    grads = [[(3.0 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    opt = optax.chain(optax.clip_by_global_norm(5.0),
                      lamb_reference(2e-3, weight_decay=1e-6))
    jp = [jnp.asarray(p) for p in ps]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    lamb = Lamb(tp, 2e-3, weight_decay=1e-6, grad_clip_norm=5.0)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        lamb.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


MICRO = ["method.voxel_sizes=[20]", "method.num_latents=32",
         "method.latent_dim=32", "method.transformer_depth=1",
         "method.cross_dim_head=8", "method.latent_dim_head=8",
         "method.final_dim=16", "method.policy_dtype=float32",
         "method.neural_renderer.image_width=32",
         "method.neural_renderer.image_height=32",
         "method.neural_renderer.d_latent=16",
         "method.neural_renderer.tile_capacity=512",
         "method.neural_renderer.chunk=32",
         "method.neural_renderer.max_tiles_per_gaussian=8",
         "rlbench.camera_resolution=[32,32]", "rlbench.demos=1",
         "rlbench.tasks=[open_drawer]", "rlbench.episode_length=8",
         "replay.use_disk=false", "framework.log_freq=1",
         "framework.save_freq=1000", "framework.num_weights_to_keep=2"]


def test_train_entry_point_on_the_cpu_with_checkpoint_and_resume(tmp_path,
                                                                  monkeypatch):
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints
    demos, logs = str(tmp_path / "demos"), str(tmp_path / "logs")
    argv = ["--demo-root", demos, "--logdir", logs, "--synthetic", *MICRO]
    first = train_cli.main(["--cpu", *argv, "framework.training_iterations=2"])[0]
    run = str(tmp_path / "logs" / "seed0")
    assert list_checkpoints(run) == [1]
    assert all(np.isfinite(v) for v in first.values())
    with open(f"{run}/train_data.csv") as f:
        header = f.readline().strip().split(",")
    for head in ("total_loss", "trans_loss", "rgb_loss", "psnr",
                 "overflow_splats", "overflow_gaussians"):
        assert head in header
    second = train_cli.main(["--cpu", *argv, "framework.training_iterations=3",
                             "framework.load_existing_weights=true"])[0]
    assert list_checkpoints(run) == [1, 2]
    assert np.isfinite(second["total_loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([*argv, "framework.training_iterations=4"])


def test_replay_fill_and_batches_match_jax(tmp_path):
    from manigaussian_tpu.data.language import create_language_model as j_lang
    from manigaussian_tpu.data.pipeline import assemble_batch as j_assemble
    from manigaussian_tpu.data.pipeline import fill_replay as j_fill
    from manigaussian_tpu.data.replay import TaskUniformReplay as JReplay
    from manigaussian_tpu_torch.data.language import \
        create_language_model as t_lang
    from manigaussian_tpu_torch.data.pipeline import assemble_batch, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.data.synthetic import generate_task
    root = str(tmp_path)
    generate_task(root, "open_drawer", num_episodes=2, timesteps=12, h=16,
                  w=16, nerf_views=3, nerf_hw=16)
    args = (root, "open_drawer", 2, ("front",),
            (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6), 100, 5, 15)
    jr, tr = JReplay(storage="pickle"), TaskUniformReplay()
    assert j_fill(jr, *args, j_lang("stub")) == fill_replay(tr, *args, t_lang("stub"))
    jt, tt = jr._mem["open_drawer"], tr._mem["open_drawer"]
    for a, b in zip(jt, tt):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray) and a[k].dtype.kind in "biuf":
                np.testing.assert_allclose(b[k], a[k], atol=1e-6, err_msg=k)
            else:
                assert np.array_equal(np.asarray(b[k]), np.asarray(a[k])), k
    jb = j_assemble(jt[:2], np.random.default_rng(0), 3)
    tb = assemble_batch(tt[:2], np.random.default_rng(0), 3)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], atol=1e-5, err_msg=k)
