"""The act's CUDA graph (`agents/bc_agent.ManiGaussianBCAgent.act`): on CUDA
the first act of an observation signature captures everything after the
inputs' upload, every later act uploads and replays it.

Marked `gpu` (each case skips without a CUDA device) but for the CPU cases
at the top, which hold that the graph never engages on the CPU. This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_act_graph_gpu.py -m gpu

On the card, at the micro `w_geo` width with the bf16 flash kernel's least
head dim (16), in float32 and bfloat16: every frame of the benchmark's `act`
traffic replayed gives the eager act's answer bit for bit; an answer kept
from act 1 is unchanged after acts 2-10; new weights loaded in place, or one
training update, give the new weights' eager answer from the same graph; a
second observation shape captures a second graph; a replay from host
(numpy) inputs makes no synchronising call.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch import config as C
from manigaussian_tpu_torch.agents.bc_agent import (ActResult,
                                                    ManiGaussianBCAgent)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "bfloat16"]
# a seed past 32 bits, as the benchmark's are
TRAFFIC_SEED = 2200000001


def micro_cfg(policy_dtype="float32", lr=None):
    cfg = C.micro_variant("w_geo", camera_resolution=(16, 16))
    # the bf16 flash kernel's least head dim
    method = dataclasses.replace(cfg.method, policy_dtype=policy_dtype,
                                 latent_dim_head=16)
    if lr is not None:
        method = dataclasses.replace(method, lr=lr)
    return dataclasses.replace(cfg, method=method)


def random_obs(seed, hw=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "rgb": rng.uniform(size=(1, 1, hw, hw, 3)).astype(f),
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((1, 1, hw, hw, 3))).astype(f),
        "low_dim_state": rng.uniform(size=(1, 4)).astype(f),
        "lang_goal_emb": (0.1 * rng.standard_normal((1, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((1, 77, 512))).astype(f),
    }


def train_batch(seed=0, hw=16, img=32):
    """One training batch at batch 1 (the update's keys)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    return {
        **random_obs(seed, hw),
        "trans_action_indicies": np.array([[10, 9, 11]], np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]], np.int32),
        "ignore_collisions": np.ones((1, 1), np.int32),
        "gripper_pose": np.array([[0.2, 0, 1.1, 0, 0, 0, 1.0]], f),
        "nerf_target_rgb": rng.uniform(size=(1, img, img, 3)).astype(f),
        "nerf_target_pose": np.eye(4, dtype=f)[None],
        "nerf_target_intrinsic": intr[None],
    }


def same(a: ActResult, b: ActResult) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def storages(res: ActResult):
    return {t.untyped_storage().data_ptr() for t in res}


def assert_kept_answers_stay_distinct(agent, frames):
    """Two kept answers of different frames share no storage, and the first
    reads the same after the second act as before it."""
    first = agent.act(frames[0])
    kept = [t.clone() for t in first]
    second = agent.act(frames[1])
    assert not storages(first) & storages(second)
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


# ---- the CPU: the eager act, as before the graph ------------------------


def test_the_graph_never_engages_on_the_cpu():
    agent = ManiGaussianBCAgent(micro_cfg(), device="cpu", seed=3)
    frames = [random_obs(s) for s in range(3)]
    answers = [agent.act(f) for f in frames]
    assert agent.act_graph_counts == {"captures": 0, "replays": 0,
                                      "eager": 3}
    assert not agent._act_graphs
    for f, res in zip(frames, answers):
        assert same(res, agent._act_eager(f))


def test_kept_answers_of_two_frames_stay_distinct_on_the_cpu():
    agent = ManiGaussianBCAgent(micro_cfg(), device="cpu", seed=3)
    assert_kept_answers_stay_distinct(agent, [random_obs(1), random_obs(2)])


# ---- the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def traffic():
    """Every frame of the benchmark's `act` traffic (two synthetic
    open_drawer demonstrations of 16 steps, 128² front camera) as the act
    cell feeds it: numpy arrays on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    import sys
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.reference import data as ref_data
    from benchmark.traffic.generator import make_episodes
    with open(os.path.join(ROOT, "benchmark", "traffic", "act.json")) as f:
        episodes = json.load(f)["episodes"]
    out = []
    for ep in make_episodes(TRAFFIC_SEED, **episodes):
        for t in range(ep["front_rgb"].shape[0]):
            obs = ref_data.observation(ep, t, torch.device("cpu"))
            out.append({k: v.numpy() for k, v in obs.items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", DTYPES)
def test_replays_equal_the_eager_act_on_every_frame(cuda, traffic,
                                                    policy_dtype):
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device=cuda, seed=3)
    for i, obs in enumerate(traffic):
        got = agent.act(obs)
        want = agent._act_eager(obs)
        assert same(got, want), i
    assert agent.act_graph_counts == {"captures": 1,
                                      "replays": len(traffic) - 1,
                                      "eager": 0}
    # the traffic's frames are not all one answer, so equality has power
    assert len({tuple(agent.act(o).trans_coords[0].tolist())
                for o in traffic}) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", DTYPES)
def test_a_kept_answer_survives_later_replays(cuda, traffic, policy_dtype):
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device=cuda, seed=3)
    assert_kept_answers_stay_distinct(agent, traffic[:2])
    first = agent.act(traffic[0])
    kept = [t.clone() for t in first]
    later = [agent.act(o) for o in traffic[1:10]]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not any(storages(first) & storages(r) for r in later)
    assert agent.act_graph_counts["captures"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", DTYPES)
def test_weights_loaded_in_place_replay_the_new_answer(cuda, traffic,
                                                       policy_dtype):
    cfg = micro_cfg(policy_dtype)
    agent = ManiGaussianBCAgent(cfg, device=cuda, seed=3)
    other = ManiGaussianBCAgent(cfg, device=cuda, seed=4)
    frames = traffic[:8]
    before = [agent.act(o) for o in frames]
    agent.qfn.load_state_dict(other.qfn.state_dict())
    after = [agent.act(o) for o in frames]
    for o, got in zip(frames, after):
        assert same(got, other._act_eager(o))
    assert not all(same(a, b) for a, b in zip(before, after))
    assert agent.act_graph_counts == {"captures": 1, "replays": 15,
                                      "eager": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", DTYPES)
def test_a_training_update_replays_the_new_answer(cuda, traffic,
                                                  policy_dtype):
    # a large step, so that one update moves the answers
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype, lr=0.5), device=cuda,
                                seed=3)
    frames = traffic[:8]
    before = [agent.act(o) for o in frames]
    agent.update(train_batch(), torch.Generator().manual_seed(5))
    after = [agent.act(o) for o in frames]
    for o, got in zip(frames, after):
        assert same(got, agent._act_eager(o))
    assert not all(same(a, b) for a, b in zip(before, after))
    assert agent.act_graph_counts == {"captures": 1, "replays": 15,
                                      "eager": 0}


@pytest.mark.gpu
def test_a_rebound_parameter_captures_again(cuda, traffic):
    agent = ManiGaussianBCAgent(micro_cfg(), device=cuda, seed=3)
    agent.act(traffic[0])
    name, p = next(iter(agent.qfn.named_parameters()))
    module = agent.qfn.get_submodule(name.rpartition(".")[0])
    setattr(module, name.rpartition(".")[2],
            torch.nn.Parameter(p.detach() * -1.0))
    got = agent.act(traffic[1])
    assert same(got, agent._act_eager(traffic[1]))
    assert agent.act_graph_counts == {"captures": 2, "replays": 0,
                                      "eager": 0}


@pytest.mark.gpu
def test_a_second_shape_captures_a_second_graph(cuda, traffic):
    agent = ManiGaussianBCAgent(micro_cfg(), device=cuda, seed=3)
    small = [{k: (v[:, :, ::2, ::2] if k in ("rgb", "pcd") else v)
              for k, v in o.items()} for o in traffic[:3]]
    run = [traffic[0], small[0], traffic[1], small[1], small[2], traffic[2]]
    for obs in run:
        assert same(agent.act(obs), agent._act_eager(obs))
    assert agent.act_graph_counts == {"captures": 2, "replays": 4,
                                      "eager": 0}
    assert len(agent._act_graphs) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", DTYPES)
def test_a_replay_from_the_host_does_not_sync(cuda, traffic, policy_dtype):
    """Numpy inputs, so the replay uploads through the pinned buffers: any
    synchronising call raises."""
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device=cuda, seed=3)
    agent.act(traffic[0])
    want = agent._act_eager(traffic[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = agent.act(traffic[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert same(got, want)
    assert agent.act_graph_counts["replays"] == 1
