"""The port's recorded-transcript envs (`envs/transcript.py`) against the
JAX package's, and the RLBench client's missing-simulator error.

Exact checks: a session recorded by the port's recorder is line for line
the JSONL JAX's recorder writes for the same session (each wraps its own
package's replay of one transcript of the mock env, 16² synthetic demos);
a JAX transcript replays in the port, and the port's in JAX, with
the recorded responses bit for bit; divergence, recorded errors and
exhaustion behave as in JAX; the full eval replayed through the port's
sim-host server (`--backend transcript`) gives the recorded run's rows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from manigaussian_tpu.envs.rlbench_env import RLBenchEnvClient as JRLBench
from manigaussian_tpu.envs.transcript import TranscriptRecorder as JRecorder
from manigaussian_tpu.envs.transcript import TranscriptReplayEnv as JReplay
from manigaussian_tpu_torch.data.synthetic import generate_task
from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
from manigaussian_tpu_torch.envs.rlbench_env import RLBenchEnvClient
from manigaussian_tpu_torch.envs.transcript import (TranscriptRecorder,
                                                    TranscriptReplayEnv)
from tests.test_torch_envs_rpc import oracle_actions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "open_drawer"


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demos_transcript"))
    generate_task(root, TASK, num_episodes=2, timesteps=10, h=16, w=16,
                  nerf_views=3, nerf_hw=16)
    return root


def _drive(env, actions):
    env.launch()
    env.set_task(TASK)
    env.reset_to_demo(0)
    results = []
    for a in actions:
        res = env.step(a)
        results.append(res)
        if res.terminal:
            break
    env.shutdown()
    return results


def _session(recorder_cls, env, path, actions):
    _drive(recorder_cls(env, path), actions)
    with open(path) as f:
        return f.read().splitlines()


def test_port_recorder_writes_jaxs_lines(demo_root, tmp_path):
    """Each recorder wraps its own package's replay of one recorded session
    (the two mock envs' point clouds differ in the last bit, and each
    package's encoder knows only its own observation type): the two new
    transcripts are the recorded one, line for line."""
    actions = oracle_actions(demo_root)
    base = _session(TranscriptRecorder, MockEnvClient(demo_root),
                    str(tmp_path / "base.jsonl"), actions)
    assert len(base) == 4 + len(actions)
    mine = _session(TranscriptRecorder,
                    TranscriptReplayEnv(str(tmp_path / "base.jsonl")),
                    str(tmp_path / "port.jsonl"), actions)
    theirs = _session(JRecorder, JReplay(str(tmp_path / "base.jsonl")),
                      str(tmp_path / "jax.jsonl"), actions)
    assert mine == theirs == base


def test_jax_transcript_replays_in_the_port(demo_root, tmp_path):
    from manigaussian_tpu.envs.mock_env import MockEnvClient as JEnv
    path = str(tmp_path / "jax.jsonl")
    actions = oracle_actions(demo_root)
    recorded = _drive(JRecorder(JEnv(demo_root), path), actions)
    rep = TranscriptReplayEnv(path)
    replayed = _drive(rep, actions)
    rep.assert_exhausted()
    assert [r.reward for r in replayed] == [r.reward for r in recorded]
    assert sum(r.reward for r in replayed) == 100.0
    for a, b in zip(replayed, recorded):
        assert a.terminal == b.terminal
        for f in ("rgb", "pcd", "low_dim_state"):
            assert np.array_equal(getattr(a.observation, f),
                                  getattr(b.observation, f))
    # and the port's transcript in JAX's replay
    port_path = str(tmp_path / "port.jsonl")
    _drive(TranscriptRecorder(MockEnvClient(demo_root), port_path), actions)
    jrep = JReplay(port_path)
    assert [r.reward for r in _drive(jrep, actions)] == \
        [r.reward for r in recorded]
    jrep.assert_exhausted()


def test_divergence_is_detected(demo_root, tmp_path):
    path = str(tmp_path / "session.jsonl")
    actions = oracle_actions(demo_root)
    _drive(TranscriptRecorder(MockEnvClient(demo_root), path), actions)
    rep = TranscriptReplayEnv(path)
    rep.launch()
    with pytest.raises(RuntimeError, match="conformance failure"):
        rep.reset_to_demo(0)                         # recorded: set_task
    bad = actions[0].copy()
    bad[0] += 1.0
    rep = TranscriptReplayEnv(path)
    rep.launch()
    rep.set_task(TASK)
    with pytest.raises(RuntimeError, match="conformance failure"):
        rep.reset_to_demo(1)                         # recorded: episode 0
    rep = TranscriptReplayEnv(path)
    rep.launch()
    rep.set_task(TASK)
    rep.reset_to_demo(0)
    with pytest.raises(RuntimeError, match="action diverged"):
        rep.step(bad)
    lax = TranscriptReplayEnv(path, strict=False)
    lax.launch()
    lax.set_task(TASK)
    lax.reset_to_demo(0)
    with pytest.warns(UserWarning, match="divergence"):
        lax.step(bad)
    assert len(lax.divergences) == 1
    with pytest.raises(RuntimeError, match="not exhausted"):
        lax.assert_exhausted()


def test_recorded_error_replays_as_error(demo_root, tmp_path):
    class ExplodingEnv(MockEnvClient):
        def step(self, action):
            raise ValueError("IK solver diverged")

    path = str(tmp_path / "err.jsonl")
    rec = TranscriptRecorder(ExplodingEnv(demo_root), path)
    rec.launch()
    rec.set_task(TASK)
    rec.reset_to_demo(0)
    a = oracle_actions(demo_root)[0]
    with pytest.raises(ValueError):
        rec.step(a)
    rec.shutdown()
    for replay_cls in (TranscriptReplayEnv, JReplay):
        rep = replay_cls(path)
        rep.launch()
        rep.set_task(TASK)
        rep.reset_to_demo(0)
        with pytest.raises(RuntimeError, match="IK solver diverged"):
            rep.step(a)
        rep.shutdown()
        rep.assert_exhausted()
        with pytest.raises(RuntimeError, match="exhausted"):
            rep.step(a)


def test_eval_replays_through_the_transcript_server(demo_root, tmp_path):
    """Record an eval against the mock env, then run the same eval through
    `rpc://` against the port's sim-host server replaying the transcript,
    and through `transcript://` in the process: the recorded rows, the
    transcript replayed whole."""
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
    path = str(tmp_path / "eval.jsonl")
    logs = {n: str(tmp_path / n) for n in ("rec", "rpc", "file")}
    for d in logs.values():
        save_checkpoint(d, 100, agent.qfn, cfg=cfg)
    recorded = run_eval(agent, logs["rec"], TranscriptRecorder(
        MockEnvClient(demo_root, pos_tol=1.0), path), [TASK], **kw)

    replay = make_env(cfg, demo_root, f"transcript://{path}")
    assert isinstance(replay, TranscriptReplayEnv)
    assert run_eval(agent, logs["file"], replay, [TASK], **kw) == recorded
    replay.assert_exhausted()

    proc = subprocess.Popen(
        [sys.executable, "-m", "manigaussian_tpu_torch.sim_host_server",
         "--host", "127.0.0.1", "--port", "0", "--backend", "transcript",
         "--transcript", path], cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        port = proc.stdout.readline().strip().rsplit(":", 1)[1]
        env = make_env(cfg, demo_root, f"rpc://127.0.0.1:{port}")
        assert run_eval(agent, logs["rpc"], env, [TASK], **kw) == recorded
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_rlbench_client_without_the_simulator_raises_jaxs_error(tmp_path):
    with pytest.raises(RuntimeError) as theirs:
        JRLBench(str(tmp_path))
    with pytest.raises(RuntimeError) as mine:
        RLBenchEnvClient(str(tmp_path))
    assert str(mine.value) == str(theirs.value)
    assert "requires rlbench+pyrep+CoppeliaSim" in str(mine.value)
    assert isinstance(mine.value.__cause__, ImportError)
