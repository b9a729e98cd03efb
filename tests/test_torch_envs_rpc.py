"""The port's RPC env bridge (`envs/rpc.py`) and sim-host server
(`python -m manigaussian_tpu_torch.sim_host_server`) against the JAX
package's: the wire protocol is the contract between the two, so a port
client talks to a JAX server and a JAX client to a port server.

Exact checks: observations bit for bit against the serving env's own (the
mock env of the server's package, 16² synthetic demos), the oracle actions'
rewards and terminals, the eval rows through `rpc://` against the local
env's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from manigaussian_tpu.data.synthetic import generate_task
from manigaussian_tpu.envs import base as jbase
from manigaussian_tpu.envs.mock_env import MockEnvClient as JEnv
from manigaussian_tpu.envs.rpc import EnvRPCServer as JServer
from manigaussian_tpu.envs.rpc import RPCEnvClient as JClient
from manigaussian_tpu_torch.data import episode as ep
from manigaussian_tpu_torch.data.keypoints import keypoint_discovery
from manigaussian_tpu_torch.envs import base as tbase
from manigaussian_tpu_torch.envs.mock_env import MockEnvClient as TEnv
from manigaussian_tpu_torch.envs.rpc import EnvRPCServer as TServer
from manigaussian_tpu_torch.envs.rpc import RPCEnvClient as TClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "open_drawer"


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demos_rpc"))
    generate_task(root, TASK, num_episodes=2, timesteps=10, h=16, w=16,
                  nerf_views=3, nerf_hw=16)
    return root


def oracle_actions(root):
    demo = ep.load_episode(ep.list_episodes(root, TASK)[0])
    kps = keypoint_discovery(demo.gripper_open, demo.joint_velocities)
    return [np.concatenate([demo.gripper_pose[kp], [demo.gripper_open[kp]],
                            [0.0]]).astype(np.float32) for kp in kps]


def _same_obs(a, b):
    for f in ("rgb", "pcd", "low_dim_state"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.lang_goal == b.lang_goal


@pytest.mark.parametrize("server_side,client_side", [
    ((JServer, JEnv), (TClient, tbase)),
    ((TServer, TEnv), (JClient, jbase)),
])
def test_clients_and_servers_of_both_packages(demo_root, server_side,
                                              client_side):
    (server_cls, env_cls), (client_cls, base) = server_side, client_side
    server = server_cls(env_cls(demo_root), port=0).start_background()
    client = client_cls(f"rpc://127.0.0.1:{server.port}")
    local = env_cls(demo_root)
    try:
        assert client.ping() == "pong"
        client.launch()
        for env in (client, local):
            env.set_task(TASK)
        for episode in (0, 1):
            obs = client.reset_to_demo(episode)
            assert isinstance(obs, base.EnvObservation)
            _same_obs(obs, local.reset_to_demo(episode))
        client.reset_to_demo(0)
        local.reset_to_demo(0)
        rewards = []
        for a in oracle_actions(demo_root):
            got, want = client.step(a), local.step(a)
            assert isinstance(got, base.EnvStepResult)
            assert (got.reward, got.terminal) == (want.reward, want.terminal)
            _same_obs(got.observation, want.observation)
            rewards.append(got.reward)
            if got.terminal:
                break
        assert sum(rewards) == 100.0                 # the oracle succeeds
    finally:
        client.shutdown()
        server.close()


@pytest.mark.parametrize("client_cls", [TClient, JClient])
def test_sim_errors_come_back_as_runtime_error(demo_root, client_cls):
    class ExplodingEnv(TEnv):
        def step(self, action):
            raise ValueError("IK solver diverged")

    server = TServer(ExplodingEnv(demo_root), port=0).start_background()
    client = client_cls(f"127.0.0.1:{server.port}")
    try:
        client.set_task(TASK)
        client.reset_to_demo(0)
        with pytest.raises(RuntimeError,
                           match="ValueError: IK solver diverged"):
            client.step(np.zeros(9))
        with pytest.raises(RuntimeError, match="unknown rpc method"):
            client._call("render")
    finally:
        client.shutdown()
        server.close()


def test_eval_through_rpc_equals_local(demo_root, tmp_path):
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.runners.eval_runner import make_env, run_eval
    from manigaussian_tpu_torch.utils.checkpoint import save_checkpoint
    from tests.test_torch_act_eval import _cfg
    from tests.torch_port_helpers import torch_config

    cfg = torch_config(_cfg())
    agent = ManiGaussianBCAgent(cfg, device="cpu", seed=1)
    kw = dict(eval_type="last", eval_episodes=2, episode_length=4,
              lang_model=create_language_model("stub"))
    rows = {}
    for name in ("local", "rpc"):
        logdir = str(tmp_path / name)
        save_checkpoint(logdir, 100, agent.qfn, cfg=cfg)
        if name == "local":
            rows[name] = run_eval(agent, logdir, TEnv(demo_root, pos_tol=1.0),
                                  [TASK], **kw)
            continue
        server = TServer(TEnv(demo_root, pos_tol=1.0), port=0)
        server.start_background()
        env = make_env(cfg, demo_root, f"rpc://127.0.0.1:{server.port}")
        assert isinstance(env, TClient) and env.port == server.port
        rows[name] = run_eval(agent, logdir, env, [TASK], **kw)
        server.close()
    assert rows["rpc"] == rows["local"] and len(rows["rpc"]) == 1


def test_sim_host_server_prints_its_address_and_serves(demo_root, tmp_path):
    """`--port 0` binds a free port and says which on its first line; the
    session it serves is recorded with `--record`."""
    record = str(tmp_path / "session.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "manigaussian_tpu_torch.sim_host_server",
         "--host", "127.0.0.1", "--port", "0", "--backend", "mock",
         "--dataset-root", demo_root, "--record", record],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        prefix = "[sim-host] serving mock env on 127.0.0.1:"
        assert line.startswith(prefix), (line, proc.stderr.read()
                                         if proc.poll() is not None else "")
        client = TClient(f"rpc://127.0.0.1:{line[len(prefix):]}")
        client.launch()
        client.set_task(TASK)
        local = TEnv(demo_root)
        local.set_task(TASK)
        _same_obs(client.reset_to_demo(1), local.reset_to_demo(1))
        client.shutdown()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    with open(record) as f:
        methods = [line.split('"method": "')[1].split('"')[0] for line in f]
    assert methods == ["launch", "set_task", "reset_to_demo", "shutdown"]
