"""The port's results chain and learning diagnosis against the JAX package's
scripts on the CPU.

`make_results_artifact.run` at 1 task, 4 iterations, `save_freq` 2, 1
held-out episode and 1 worker: its per-seed CSV is what the JAX script
writes for the same rows (pandas), its columns are those JAX's
`evaluate_checkpoint` gives a 1-task row, its training CSV has the columns
of the committed JAX artifact's, and JAX's `compute_results.aggregate`
reads the port's CSVs to the port's summary. (The JAX script itself takes
minutes to compile its micro step on the CPU; its eval rows are held to the
port's in tests/test_torch_eval_workers.py.)

`diagnose_learning.keyframe_accuracy` of seeded random JAX weights,
converted, equals JAX's on replays filled from the same demos (exact: the
same discrete actions).
"""

import csv
import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from manigaussian_tpu.analysis import compute_results as jcr
from manigaussian_tpu.data.language import create_language_model as jl
from manigaussian_tpu.runners import eval_runner as jer
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.scripts import diagnose_learning as tdl
from manigaussian_tpu_torch.scripts import make_results_artifact as tra
from tests.torch_port_helpers import (jax_script, random_flax_params,
                                      torch_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("open_drawer",)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifact")
    out = str(root / "out")
    summary = tra.run(out, seeds=1, tasks=TASKS, iterations=4, save_freq=2,
                      episodes=1, workers=1, work_dir=str(root / "work"),
                      device="cpu")
    return out, str(root / "work"), summary


def test_artifact_files_and_columns_are_jax(artifact, monkeypatch):
    out, work, summary = artifact
    assert sorted(os.listdir(out)) == ["0.csv", "config.json",
                                       "summary.json", "train_0.csv"]
    with open(os.path.join(out, "0.csv")) as f:
        text = f.read()
    rows = list(csv.DictReader(text.splitlines()))
    assert [float(r["step"]) for r in rows] == [2.0, 3.0]
    # the bytes the JAX script writes for the same rows
    from manigaussian_tpu_torch.runners.eval_runner import read_eval_csv
    port_rows = read_eval_csv(os.path.join(work, "logs", "seed0"))
    assert pd.DataFrame(port_rows).to_csv(index=False) == text
    # the columns JAX's evaluate_checkpoint makes for this task list
    monkeypatch.setattr(jer, "restore_checkpoint",
                        lambda *a, **k: (SimpleNamespace(params=None), 0))
    monkeypatch.setattr(jer, "rollout_episode", lambda *a, **k: (0.0, 1))
    jrow = jer.evaluate_checkpoint(
        SimpleNamespace(jit_act=lambda: None), work, 2,
        SimpleNamespace(set_task=lambda t: None), TASKS, 1, 8,
        jl("stub"), None)
    assert list(rows[0]) == list(jrow)
    with open(os.path.join(REPO, "results", "synthetic_micro", "w_geo",
                           "train_0.csv")) as f:
        jax_train_cols = set(next(csv.reader(f)))
    with open(os.path.join(out, "train_0.csv")) as f:
        assert set(next(csv.reader(f))) == jax_train_cols
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary


def test_jax_aggregate_reads_the_port_csvs(artifact):
    out, _, summary = artifact
    csvs = [os.path.join(out, "0.csv")]
    for method in ("last", "best"):
        mean, std, per_seed = jcr.aggregate(csvs, method)
        assert summary[method] == {"mean": mean, "std": std,
                                   "per_seed": per_seed}
    avg = jcr.calculate_average_return(pd.read_csv(csvs[0]))
    assert np.isfinite(avg).all()


def test_keyframe_accuracy_equals_jax(tmp_path):
    from manigaussian_tpu.agents.registry import create_agent as j_agent
    from manigaussian_tpu.data.pipeline import assemble_batch as j_assemble
    from manigaussian_tpu.data.pipeline import fill_replay as j_fill
    from manigaussian_tpu.data.replay import TaskUniformReplay as JReplay
    from manigaussian_tpu.data.synthetic import generate_task
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay

    jdl = jax_script("diagnose_learning")
    jcfg = jdl.micro_cfg(list(TASKS), 4, 2)
    jcfg = dataclasses.replace(jcfg, method=dataclasses.replace(
        jcfg.method, use_neural_rendering=False))
    tcfg = tdl.micro_cfg(list(TASKS), 4, 2)
    tcfg = dataclasses.replace(tcfg, method=dataclasses.replace(
        tcfg.method, use_neural_rendering=False))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(torch_config(jcfg))
    root = str(tmp_path)
    generate_task(root, TASKS[0], num_episodes=jcfg.rlbench.demos,
                  timesteps=12, h=16, w=16, nerf_views=3, nerf_hw=32, seed=0)
    replays = []
    for replay, fill, lang in ((JReplay(), j_fill, jl("stub")),
                               (TaskUniformReplay(), fill_replay,
                                create_language_model("stub"))):
        fill(replay, root, TASKS[0], jcfg.rlbench.demos, jcfg.rlbench.cameras,
             jcfg.rlbench.scene_bounds, jcfg.method.voxel_sizes[0],
             jcfg.method.rotation_resolution, jcfg.rlbench.episode_length,
             lang)
        replays.append(replay)
    jreplay, treplay = replays

    jagent = j_agent(jcfg)
    b = j_assemble([jreplay._get(TASKS[0], 0)], np.random.default_rng(0),
                   load_nerf_targets=False)
    obs = [jnp.asarray(b[k]) for k in ("rgb", "pcd", "low_dim_state",
                                       "lang_goal_emb", "lang_token_embs")]
    params = random_flax_params(jagent.qfn, *obs, jagent.bounds, seed=5)
    want = jdl.keyframe_accuracy(jagent, params, jreplay, jagent.jit_act())
    tagent = create_agent(tcfg, device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))
    got = tdl.keyframe_accuracy(tagent, treplay)
    assert got == want and got["n"] == jreplay.size()
