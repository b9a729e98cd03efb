"""The port's sharded training step on the CPU (gloo, one process a rank)
against its one-process step on the global batch, and against JAX.

Micro `w_geo` (the splat renderer on), fp32 policy, dropout 0.1 / 0.1, the
augmentation on, global batch 2, two steps from the same seeded weights
and generator: `--mesh 2` (data parallel), `--mesh-tile 2` (the renderer's
tiles over two ranks) and the (2, 2) mesh of both.

Each sharded step is held to the one-process step from the same inputs:
step k of the reference starts from what the sharded run held before its
step k (parameters, LAMB state, step count, generator state). Two
trajectories part after one step by more than rounding: LAMB moves an
element by about lr·trust in its gradient's sign, and an element whose
gradient is rounding noise (last-bit differences between the ranks' and
the one process's sums) may take either sign, so the second step's losses
of two runs differ by what the init happens to give. Compared step by step
the rules hold whatever the init. Tolerances, each measured on this
configuration first:
  * every metric of every step within 1e-5·max(1, |x|) of the one-process
    step's: the draws are the global batch's, so the
    ranks drop what the one-process step drops;
  * every step's averaged gradient of every leaf within 3e-3 of the
    one-process gradient's norm, in norm (measured ≤ 9.8e-4, in the U-Net
    encoder: its leaves' gradients are sums over 20³ voxels that mostly
    cancel, summed in fp32 over other row counts); the one leaf whose exact
    gradient is zero (the bias shared by the translation softmax's logits,
    Σp − 1) within 1e-6;
  * what the step leaves for the next one equal to what the one-process
    step leaves: the step count, the optimizer's count and the generator's
    state exactly, LAMB's moments mu and nu by the gradient's rule (3e-3 of
    the norm, measured ≤ 5.7e-4; NOISE_LEAF within 1e-6);
  * every rank's parameters equal bit for bit after every step;
  * after every step each parameter within twice its leaf's largest move in
    the one-process step from the same parameters (LAMB's either-sign moves
    of noise-gradient elements, as above, so equal gradients within the
    rule above do not bound the parameters any tighter), and each leaf's
    move in norm within 1e-3 of the one-process step's (LAMB's step is
    lr·trust in norm, whatever its elements' signs; measured ≤ 1.5e-4), so
    a step skipped or scaled fails; NOISE_LEAF's move is noise over eps
    and is held only by the elementwise rule.
Against JAX (`tests/test_parallel.py`'s data-parallel test: the policy
alone, no augmentation, fp32, dropout 0): the 2-rank step's metrics within
1e-4·max(1, |x|) of JAX's one-device `update` from converted weights (the
port's one-process step is held to the same rule in test_torch_train.py).
The train CLI's multi-process runs are held in test_torch_parallel_cli.py.
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
from tests.torch_parallel_workers import (act_worker, one_process_steps,
                                          run_ranks, train_worker)
from tests.torch_port_helpers import random_flax_params, torch_config

NOISE_LEAF = "qnet.trans_decoder.bias"
STEPS = 2


def micro(**method):
    cfg = JC.micro_variant("w_geo")
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, **{"input_dropout": 0.1, "attn_dropout": 0.1, **method}))


def make_batch(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    return {
        "rgb": rng.uniform(size=(b, 1, hw, hw, 3)).astype(f),
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((b, 1, hw, hw, 3))).astype(f),
        "low_dim_state": rng.standard_normal((b, 4)).astype(f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": rng.integers(2, 18, (b, 3)).astype(np.int32),
        "rot_grip_action_indicies": np.concatenate(
            [rng.integers(0, 72, (b, 3)), rng.integers(0, 2, (b, 1))],
            axis=1).astype(np.int32),
        "ignore_collisions": rng.integers(0, 2, (b, 1)).astype(np.int32),
        "gripper_pose": np.tile(np.array([0.2, 0, 1.1, 0, 0, 0, 1.0], f), (b, 1)),
        "action": np.zeros((b, 8), f),
        "nerf_target_rgb": rng.uniform(size=(b, hw, hw, 3)).astype(f),
        "nerf_target_pose": np.tile(np.eye(4, dtype=f), (b, 1, 1)),
        "nerf_target_intrinsic": np.tile(intr, (b, 1, 1)),
    }


BATCHES = [make_batch(s) for s in range(STEPS)]


def _sharded(tmp_path, shape, axes, cfg):
    world = int(np.prod(shape))
    run_ranks(train_worker, world,
              (shape, axes, dataclasses.asdict(cfg), BATCHES, str(tmp_path)),
              timeout=240)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def _names(cfg):
    from manigaussian_tpu_torch.agents.registry import create_agent
    return [n for n, _ in create_agent(cfg, device="cpu").qfn.named_parameters()]


def _check_against_one_process(ranks, cfg):
    for r in ranks:
        assert r["in_sync"]
        for step, step0 in zip(r["params"], ranks[0]["params"]):
            for a, b in zip(step, step0):
                assert torch.equal(a, b)
    got = ranks[0]
    ref = one_process_steps(cfg, BATCHES, got["starts"])
    names = _names(cfg)
    assert len(ref) == len(got["metrics"]) == STEPS
    afters = got["starts"][1:] + [got["end"]]
    for i, (metrics, grads, params, after) in enumerate(ref):
        m = got["metrics"][i]
        assert set(m) == set(metrics)
        for k in metrics:
            assert abs(m[k] - metrics[k]) <= 1e-5 * max(1.0, abs(metrics[k])), \
                (i, k, m[k], metrics[k])
        got_after = afters[i]
        assert got_after["step"] == after["step"] == got["starts"][i]["step"] + 1
        assert got_after["opt"]["count"] == after["opt"]["count"]
        assert torch.equal(got_after["gen"], after["gen"]), i
        for name, g, gr, p, pr, w0, mu, mur, nu, nur in zip(
                names, got["grads"][i], grads, got["params"][i], params,
                got["starts"][i]["params"], got_after["opt"]["mu"],
                after["opt"]["mu"], got_after["opt"]["nu"],
                after["opt"]["nu"]):
            for what, a, b in (("grad", g, gr), ("mu", mu, mur),
                               ("nu", nu, nur)):
                if name == NOISE_LEAF:
                    assert float((a - b).abs().max()) <= 1e-6, (i, name, what)
                else:
                    assert float((a - b).norm()) <= 3e-3 * float(b.norm()), \
                        (i, name, what)
            bound = 2.0 * float((pr - w0).abs().max()) + 1e-7
            assert float((p - pr).abs().max()) <= bound, (i, name)
            if name != NOISE_LEAF:
                move, move_ref = float((p - w0).norm()), float((pr - w0).norm())
                assert abs(move - move_ref) <= 1e-3 * move_ref, \
                    (i, name, move, move_ref)


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)), ((2,), ("tile",))])
def test_sharded_update_matches_one_process(tmp_path, shape, axes):
    cfg = torch_config(micro())
    ranks = _sharded(tmp_path, shape, axes, cfg)
    _check_against_one_process(ranks, cfg)


def test_2d_mesh_update_matches_one_process(tmp_path):
    cfg = torch_config(micro())
    ranks = _sharded(tmp_path, (2, 2), ("data", "tile"), cfg)
    _check_against_one_process(ranks, cfg)


def test_data_parallel_losses_match_jax_one_device(tmp_path):
    """`tests/test_parallel.py`'s data-parallel check for the port: the
    policy alone, fp32, dropout 0, no augmentation; two ranks of batch 1."""
    cfg = micro(use_neural_rendering=False, apply_se3=False,
                input_dropout=0.0, attn_dropout=0.0)
    batch = make_batch(7)
    jagent = JAgent(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds, seed=5)
    state = TrainState(jnp.zeros((), jnp.int32), params,
                       jagent.opt.init(params))
    _, jm = jax.jit(jagent.update)(state, jb, jax.random.PRNGKey(2))
    sd_path = tmp_path / "state.pt"
    torch.save(convert.qfunction_state_dict(params), sd_path)
    tcfg = torch_config(cfg)
    run_ranks(train_worker, 2, ((2,), ("data",), dataclasses.asdict(tcfg),
                                [batch], str(tmp_path), None, 3, str(sd_path)),
              timeout=240)
    got = torch.load(tmp_path / "rank0.pt")
    assert got["in_sync"]
    m = got["metrics"][0]
    assert set(m) <= set(jm) and "bc_loss" in m
    for k in m:
        v = float(jm[k])
        assert abs(m[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, m[k], v)


def test_sharded_act_gathers_the_global_batch(tmp_path):
    """`make_sharded_act`: two ranks act on their rows of a batch of 4 and
    the gathered actions equal the one-process act bit for bit (the policy
    is per sample; the gather is exact)."""
    from manigaussian_tpu_torch.agents.registry import create_agent
    cfg = torch_config(micro())
    batch = make_batch(11, b=4)
    keys = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")
    obs = {k: batch[k] for k in keys}
    run_ranks(act_worker, 2, (dataclasses.asdict(cfg), obs, str(tmp_path)),
              timeout=120)
    want = create_agent(cfg, device="cpu", seed=3).act(obs)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
