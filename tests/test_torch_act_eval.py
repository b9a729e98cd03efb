"""The whole act/eval slice of the port against the JAX package, fp32, at
the tiny config of tests/test_agent.py: `act` on one observation, and
`run_eval` on mock-env synthetic demos at 32² (same per-step actions, same
returns). Also: the port imports nothing of JAX, and its entry points run
on the CPU only when asked.

Tolerances: Q-values 1e-4 (fp32 through the whole policy, summed in
another order); continuous actions 1e-5 (voxel centers and quaternions
from identical discrete indices, which must match exactly).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu.data.language import create_language_model as j_lang
from manigaussian_tpu.data.synthetic import generate_task
from manigaussian_tpu.envs.mock_env import MockEnvClient as JEnv
from manigaussian_tpu.runners.eval_runner import run_eval as j_run_eval
from manigaussian_tpu.utils.checkpoint import save_checkpoint as j_save
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch import eval as t_eval
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from manigaussian_tpu_torch.data.language import \
    create_language_model as t_lang
from manigaussian_tpu_torch.envs.mock_env import MockEnvClient as TEnv
from manigaussian_tpu_torch.runners.eval_runner import (append_eval_csv,
                                                        run_eval,
                                                        select_checkpoints)
from manigaussian_tpu_torch.utils.checkpoint import (list_checkpoints,
                                                     restore_checkpoint,
                                                     save_checkpoint)
from tests.test_agent import make_batch, tiny_config
from tests.torch_port_helpers import (assert_close, random_flax_params,
                                      to_np, torch_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS_KEYS = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")
TASK = "open_drawer"


def _cfg(camera_resolution=(16, 16)):
    cfg = tiny_config(use_neural_rendering=False)
    return dataclasses.replace(
        cfg, method=dataclasses.replace(cfg.method, policy_dtype="float32"),
        rlbench=dataclasses.replace(cfg.rlbench,
                                    camera_resolution=camera_resolution))


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    cfg = _cfg()
    jagent = JAgent(cfg)
    batch = make_batch(jax.random.PRNGKey(0))
    obs = {k: np.array(batch[k]) for k in OBS_KEYS}   # writable copies
    params = random_flax_params(
        jagent.qfn, *(jnp.asarray(obs[k]) for k in OBS_KEYS), jagent.bounds,
        seed=4)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))
    root = str(tmp_path_factory.mktemp("demos"))
    generate_task(root, TASK, num_episodes=2, timesteps=10, h=32, w=32,
                  nerf_views=1, nerf_hw=8)
    return cfg, jagent, tagent, params, obs, root


def test_act_matches_jax(slice_setup):
    _, jagent, tagent, params, obs, _ = slice_setup
    jres = jagent.jit_act()(params, {k: jnp.asarray(v) for k, v in obs.items()})
    tres = tagent.act(obs)
    np.testing.assert_array_equal(to_np(tres.trans_coords),
                                  np.asarray(jres.trans_coords))
    np.testing.assert_array_equal(to_np(tres.rot_grip_indices),
                                  np.asarray(jres.rot_grip_indices))
    np.testing.assert_array_equal(to_np(tres.collision_indices),
                                  np.asarray(jres.collision_indices))
    assert_close(tres.continuous_action, jres.continuous_action, 1e-5)

    jq = jax.jit(jagent.qfn.apply)(
        params, jnp.asarray(obs["rgb"]) * 2.0 - 1.0,
        *(jnp.asarray(obs[k]) for k in OBS_KEYS[1:]), jagent.bounds)
    tq = tagent.q_values(obs)
    for name in ("q_trans", "q_rot_grip", "q_collision", "voxel_grid"):
        assert_close(getattr(tq, name), getattr(jq, name), 1e-4, err_msg=name)


class _RecordingEnv:
    """Forwards to an env and keeps every action it was sent."""

    def __init__(self, env):
        self.env, self.actions = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def step(self, action):
        self.actions.append(np.array(action, np.float32))
        return self.env.step(action)


def test_run_eval_matches_jax(slice_setup, tmp_path):
    cfg, _, tagent, params, _, root = slice_setup
    cfg32 = _cfg((32, 32))
    jagent = JAgent(cfg32)
    state = jax.device_get(TrainState(jnp.zeros((), jnp.int32), params,
                                      jagent.opt.init(params)))
    jlog, tlog = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_save(jlog, 100, state)
    save_checkpoint(tlog, 100, tagent.qfn, cfg=torch_config(cfg32))

    kw = dict(eval_type="last", eval_episodes=2, episode_length=5)
    jenv = _RecordingEnv(JEnv(root, pos_tol=1.0))
    jrows = j_run_eval(jagent, jlog, jenv, [TASK], lang_model=j_lang("stub"),
                       state_like=state, **kw)
    tenv = _RecordingEnv(TEnv(root, pos_tol=1.0))
    trows = run_eval(tagent, tlog, tenv, [TASK], lang_model=t_lang("stub"),
                     **kw)
    assert trows == jrows
    assert len(tenv.actions) == len(jenv.actions) >= 2
    np.testing.assert_allclose(np.stack(tenv.actions), np.stack(jenv.actions),
                               atol=1e-5, rtol=1e-5)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, with jax, flax,
    optax and the JAX package made unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'manigaussian_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, manigaussian_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked(slice_setup, tmp_path,
                                                     monkeypatch):
    cfg, _, tagent, _, _, root = slice_setup
    logdir = str(tmp_path / "logs")
    save_checkpoint(logdir, 7, tagent.qfn, cfg=torch_config(_cfg((32, 32))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TAgent(torch_config(cfg))
    argv = ["--logdir", logdir, "--demo-root", root, "--episodes", "1",
            "--episode-length", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eval.main(argv)
    rows = t_eval.main(argv + ["--cpu"])
    assert [int(r["step"]) for r in rows] == [7]
    assert "eval_envs/return" in rows[0]


def test_checkpoints_and_selection(slice_setup, tmp_path):
    _, _, tagent, _, _, _ = slice_setup
    logdir = str(tmp_path)
    save_checkpoint(logdir, 100, tagent.qfn)
    save_checkpoint(logdir, 200, tagent.qfn)
    assert list_checkpoints(logdir) == [100, 200]
    other = TAgent(torch_config(_cfg()), device="cpu", seed=1)
    _, step = restore_checkpoint(logdir, other.qfn)
    assert step == 200
    for k, v in tagent.qfn.state_dict().items():
        torch.testing.assert_close(other.qfn.state_dict()[k], v, rtol=0, atol=0)

    assert select_checkpoints(logdir, "last", [TASK]) == [200]
    assert select_checkpoints(logdir, "missing", [TASK]) == [100, 200]
    assert select_checkpoints(logdir, 100, [TASK]) == [100]
    append_eval_csv(logdir, {"step": 100, "eval_envs/return": 50.0})
    assert select_checkpoints(logdir, "missing", [TASK]) == [200]
    append_eval_csv(logdir, {"step": 200, "eval_envs/return": 10.0})
    assert select_checkpoints(logdir, "best", [TASK]) == [100]
