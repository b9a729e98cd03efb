"""The port's parallel checkpoint eval (`run_eval_parallel`, `eval
--workers`) and episode GIFs (`--record-every-n`) against its serial
`run_eval` and the JAX package's, fp32, at test_torch_act_eval.py's tiny
config on synthetic demos at 32², two tasks (so the rows carry lengths and
transitions), two checkpoints of different weights. The port's runs reach
the mock env through the RPC bridge (`rpc://`, a server in a thread of the
test) with test_torch_act_eval.py's `pos_tol` 1.0, so that random weights
pass some keyframes and the episodes differ; JAX's drives the mock env in
its own process.

Exact checks: the rows of the spawned workers, of the in-process worker,
of the serial port run and of JAX's `run_eval` on the converted weights,
and their CSV in step order; the GIFs' file names and bytes against those
JAX writes for the same episodes (the frames are the env's observations,
which equal actions make equal).
"""

import dataclasses
import glob
import multiprocessing
import os
import shutil

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
from manigaussian_tpu_torch.envs.rpc import EnvRPCServer
from manigaussian_tpu_torch.runners.eval_runner import (make_env,
                                                        read_eval_csv,
                                                        run_eval,
                                                        run_eval_parallel)
from manigaussian_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_agent import make_batch
from tests.test_torch_act_eval import OBS_KEYS, _cfg
from tests.torch_parallel_workers import eval_worker_probe
from tests.torch_port_helpers import random_flax_params, torch_config

TASKS = ("open_drawer", "close_jar")
STEPS = (100, 200)
EPISODES, LENGTH, POS_TOL = 2, 5, 1.0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Demos, a JAX and a port log dir holding checkpoints 100 and 200 of
    two weight sets (seeds 3 and 6: one reaches the end of some episodes,
    the other passes one keyframe), JAX's restore template, and the
    address of a sim-host server of the mock env."""
    cfg = _cfg((32, 32))
    cfg = dataclasses.replace(cfg, rlbench=dataclasses.replace(
        cfg.rlbench, tasks=TASKS, episode_length=LENGTH))
    jagent = JAgent(cfg)
    batch = make_batch(jax.random.PRNGKey(0))
    obs = [jnp.asarray(np.array(batch[k])) for k in OBS_KEYS]
    root = str(tmp_path_factory.mktemp("demos"))
    for task in TASKS:
        generate_task(root, task, num_episodes=2, timesteps=10, h=32, w=32,
                      nerf_views=1, nerf_hw=8)
    jlog = str(tmp_path_factory.mktemp("jax"))
    tlog = str(tmp_path_factory.mktemp("torch"))
    tcfg = torch_config(cfg)
    tagent = TAgent(tcfg, device="cpu")
    for step, seed in zip(STEPS, (3, 6)):
        params = random_flax_params(jagent.qfn, *obs, jagent.bounds, seed=seed)
        state = jax.device_get(TrainState(jnp.zeros((), jnp.int32), params,
                                          jagent.opt.init(params)))
        j_save(jlog, step, state)
        tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))
        save_checkpoint(tlog, step, tagent.qfn, cfg=tcfg)
    server = EnvRPCServer(TEnv(root, episode_length=LENGTH, pos_tol=POS_TOL),
                          port=0).start_background()
    yield (cfg, tcfg, jagent, state, root, jlog, tlog,
           f"rpc://127.0.0.1:{server.port}")
    server.close()


def _copy(logdir, tmp_path, name):
    """The log dir's checkpoints and config, without its CSV and videos."""
    dst = str(tmp_path / name)
    shutil.copytree(logdir, dst, ignore=shutil.ignore_patterns(
        "eval_data.csv", "videos"))
    return dst


def _port_serial(tcfg, root, logdir, env, **kw):
    return run_eval(TAgent(tcfg, device="cpu"), logdir,
                    make_env(tcfg, root, env), TASKS, eval_type="missing",
                    eval_episodes=EPISODES, episode_length=LENGTH,
                    lang_model=t_lang("stub"), **kw)


def _jax_serial(jagent, state, root, logdir, **kw):
    return j_run_eval(jagent, logdir,
                      JEnv(root, episode_length=LENGTH, pos_tol=POS_TOL),
                      TASKS, eval_type="missing", eval_episodes=EPISODES,
                      episode_length=LENGTH, lang_model=j_lang("stub"),
                      state_like=state, **kw)


@pytest.fixture(scope="module")
def serial(setup, tmp_path_factory):
    """The port's serial run and JAX's, each recording every 2nd episode:
    (port rows, JAX rows, port log dir, JAX log dir)."""
    _, tcfg, jagent, state, root, jlog, tlog, env = setup
    tmp = tmp_path_factory.mktemp("serial")
    tdir, jdir = _copy(tlog, tmp, "torch"), _copy(jlog, tmp, "jax")
    return (_port_serial(tcfg, root, tdir, env, record_every_n=2),
            _jax_serial(jagent, state, root, jdir, record_every_n=2),
            tdir, jdir)


@pytest.fixture(autouse=True)
def _few_threads_in_workers(monkeypatch):
    """Spawned workers read it when torch starts: several test files run at
    once, and a worker taking every core slows all of them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def test_workers_equal_serial_and_jax(setup, serial, tmp_path):
    """Two spawned workers, and the in-process path (one worker), give the
    serial run's rows, which equal JAX's; the parent writes the CSV."""
    _, tcfg, jagent, state, root, jlog, tlog, env = setup
    rows, jax_rows = serial[:2]
    assert [int(r["step"]) for r in rows] == list(STEPS)
    assert rows[0] != rows[1]
    assert max(r["eval_envs/mean_return"] for r in rows) > 0
    assert min(r[f"eval_envs/length/{t}"] for r in rows for t in TASKS) > 1
    assert rows == jax_rows
    for workers in (2, 1):
        logdir = _copy(tlog, tmp_path, f"workers{workers}")
        got = run_eval_parallel(tcfg, logdir, root, env,
                                eval_type="missing", eval_episodes=EPISODES,
                                num_workers=workers, device="cpu")
        assert got == rows, workers
        assert read_eval_csv(logdir) == rows


def test_gifs_equal_jax(serial):
    _, _, tdir, jdir = serial
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(tdir, "videos", "*")))
    assert names == sorted(f"{t}_step{s}_ep0.gif" for t in TASKS
                           for s in STEPS)
    for name in names:
        with open(os.path.join(tdir, "videos", name), "rb") as a, \
                open(os.path.join(jdir, "videos", name), "rb") as b:
            assert a.read() == b.read(), name


def test_cli_records_gifs_and_takes_workers(setup, tmp_path):
    """The CLI's --record-every-n (serial) and --workers 2 (--cpu; on the
    last checkpoint alone, which the runner evaluates in this process), on
    the mock env in the process (pos_tol 0.1: every episode misses its
    first keyframe)."""
    _, _, _, _, root, _, tlog, _ = setup
    argv = ["--demo-root", root, "--episodes", "2", "--episode-length",
            str(LENGTH), "--cpu"]
    logdir = _copy(tlog, tmp_path, "rec")
    rows = t_eval.main(["--logdir", logdir, *argv, "--eval-type", "missing",
                        "--record-every-n", "1"])
    assert len(glob.glob(os.path.join(logdir, "videos", "*.gif"))) == 8
    par = _copy(tlog, tmp_path, "par")
    assert t_eval.main(["--logdir", par, *argv, "--eval-type", "last",
                        "--workers", "2"]) == rows[-1:]
    assert not os.path.isdir(os.path.join(par, "videos"))


def test_workers_without_a_gpu_raise_before_any_spawn(setup, tmp_path,
                                                      monkeypatch):
    _, _, _, _, root, _, tlog, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker pool was started")

    monkeypatch.setattr(multiprocessing, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eval.main(["--logdir", _copy(tlog, tmp_path, "nogpu"),
                     "--demo-root", root, "--eval-type", "missing",
                     "--workers", "2"])


def test_spawned_worker_imports_no_jax(setup, serial, tmp_path):
    """`_eval_worker` in a spawned process: its row, and the modules of JAX
    and of the JAX package it imported (none)."""
    _, tcfg, _, _, root, _, tlog, env = setup
    logdir = _copy(tlog, tmp_path, "probe")
    payload = (tcfg, logdir, STEPS[0], root, env, EPISODES, "cpu", 0)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        row, jax_modules = pool.apply(eval_worker_probe, (payload,))
    assert jax_modules == []
    assert row == serial[0][0]


def test_recorder_accumulator_and_camera_path_equal_jax(tmp_path):
    """The copies beside the runner: `EpisodeRecorder` (uint8 conversion,
    GIF and PNG bytes), `SimpleAccumulator` (columns and values, one task
    and two) and `circular_camera_path`, against the JAX package's."""
    from manigaussian_tpu.runners.stat_accumulator import \
        SimpleAccumulator as JAcc
    from manigaussian_tpu.utils.video import EpisodeRecorder as JRec
    from manigaussian_tpu.utils.video import circular_camera_path as j_path
    from manigaussian_tpu_torch.runners.stat_accumulator import \
        SimpleAccumulator
    from manigaussian_tpu_torch.utils.video import (EpisodeRecorder,
                                                    circular_camera_path)

    rng = np.random.default_rng(0)
    frames = [rng.uniform(-0.2, 1.2, (16, 16, 3)).astype(np.float32)
              for _ in range(3)] + [rng.integers(0, 255, (16, 16, 3),
                                                 dtype=np.uint8)]
    for name, cls in (("port", EpisodeRecorder), ("jax", JRec)):
        rec = cls(fps=10)
        for f in frames:
            rec.add_frame(f)
        assert rec.save(str(tmp_path / name / "ep"), frames_dir=True) \
            == str(tmp_path / name / "ep.gif")
        assert rec.save(str(tmp_path / name / "empty")) is None
    for rel in ("ep.gif", "ep/0.png", "ep/3.png"):
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel

    for tasks in ((TASKS[0],), TASKS):
        mine, theirs = SimpleAccumulator(), JAcc()
        for i, task in enumerate(tasks * 3):
            for acc in (mine, theirs):
                acc.add_episode(task, 100.0 * (i % 2), i + 1,
                                "IKError" if i == 2 else None)
        out = mine.pop()
        assert out == theirs.pop() and mine.pop() == {}
        assert out["eval_envs/error/IKError"] == 1.0

    args = (np.array([0.1, -0.2, 1.0]), 0.7, 0.4, 5, 0.3)
    np.testing.assert_array_equal(circular_camera_path(*args), j_path(*args))
