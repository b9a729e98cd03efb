"""Evaluation runner: checkpoint selection + closed-loop rollouts + CSV.

Port of `manigaussian_tpu/runners/eval_runner.py` (reference `eval.py:89-143`
checkpoint modes missing / best / last / <int>, the `yarr` rollout loop,
the cinematic recorder's episode GIFs, and `eval.py:154-172`'s parallel
checkpoint evaluation). The CSV columns are the same ('eval_envs/return'
for one task, 'eval_envs/return/<task>' and friends for several).

`run_eval_parallel` evaluates checkpoints in a spawn-context pool, one
agent and env per worker, every CSV write in the parent. It keeps two
quirks of the JAX runner's workers: they record no GIFs (`_eval_worker`
passes no `record_every_n`), and they build the language model from
`cfg.method.language_model_checkpoint`, which the serial CLI does not
pass.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
from manigaussian_tpu_torch.envs.base import EnvClient
from manigaussian_tpu_torch.utils.checkpoint import (list_checkpoints,
                                                     restore_checkpoint)

EVAL_CSV = "eval_data.csv"


def read_eval_csv(logdir: str) -> List[Dict[str, float]]:
    path = os.path.join(logdir, EVAL_CSV)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [dict((k, float(v)) for k, v in row.items() if v != "")
                for row in csv.DictReader(f)]


def append_eval_csv(logdir: str, row: Dict[str, float]) -> None:
    rows = read_eval_csv(logdir)
    rows.append(row)
    fields: List[str] = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    with open(os.path.join(logdir, EVAL_CSV), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)


def select_checkpoints(logdir: str, eval_type, tasks: Sequence[str]) -> List[int]:
    """eval.py:89-143 parity."""
    weights = list_checkpoints(logdir)
    if not weights:
        return []
    if eval_type == "missing":
        done = {int(r["step"]) for r in read_eval_csv(logdir)}
        return [w for w in weights if w not in done]
    if eval_type == "best":
        rows = read_eval_csv(logdir)
        if not rows:
            raise RuntimeError(f"no {EVAL_CSV} in {logdir} for eval_type=best")
        cols = ([f"eval_envs/return/{t}" for t in tasks] if len(tasks) > 1
                else ["eval_envs/return"])
        best_step, best_score = None, -np.inf
        for r in rows:
            if int(r["step"]) not in weights:
                continue
            score = float(np.mean([r[c] for c in cols if c in r]))
            if score >= best_score:
                best_score, best_step = score, int(r["step"])
        return [best_step] if best_step is not None else []
    if eval_type == "last":
        return [weights[-1]]
    if isinstance(eval_type, int):
        return [eval_type]
    raise ValueError(f"unknown eval_type {eval_type!r}")


def rollout_episode(agent: ManiGaussianBCAgent, env: EnvClient,
                    episode_index: int, episode_length: int,
                    lang_emb, lang_tokens, with_length: bool = False,
                    recorder=None):
    """One closed-loop episode with the agent's current weights; returns the
    episode return (or (return, steps_taken) when with_length). `recorder`
    (a utils/video.EpisodeRecorder) collects the front camera's frames: the
    first observation's, then one after each step."""
    obs = env.reset_to_demo(episode_index)
    total = 0.0
    steps = 0
    if recorder is not None:
        recorder.add_frame(obs.rgb[0])
    for _ in range(episode_length):
        batch_obs = {
            "rgb": obs.rgb[None], "pcd": obs.pcd[None],
            "low_dim_state": obs.low_dim_state[None],
            "lang_goal_emb": lang_emb[None],
            "lang_token_embs": lang_tokens[None],
        }
        res = agent.act(batch_obs)
        step_res = env.step(res.continuous_action[0].cpu().numpy())
        total += step_res.reward
        steps += 1
        obs = step_res.observation
        if recorder is not None:
            recorder.add_frame(obs.rgb[0])
        if step_res.terminal:
            break
    return (total, steps) if with_length else total


def evaluate_checkpoint(agent: ManiGaussianBCAgent, logdir: str, step: int,
                        env: EnvClient, tasks: Sequence[str],
                        eval_episodes: int, episode_length: int,
                        lang_model, record_every_n: int = 0,
                        episode_offset: int = 0) -> Dict[str, float]:
    """Load checkpoint `step` into the agent and roll out every task;
    record_every_n > 0 writes episode e's frames to
    <logdir>/videos/<task>_step<step>_ep<e>.gif when e % record_every_n == 0."""
    module, _ = restore_checkpoint(logdir, agent.qfn, step=step)
    if module is None:
        raise FileNotFoundError(f"checkpoint {step} missing in {logdir}")

    row: Dict[str, float] = {"step": float(step)}
    per_task = []
    total_transitions = 0  # cumulative across tasks, reference CSV convention
    for task in tasks:
        env.set_task(task)
        sent, toks = lang_model.encode(task.replace("_", " "))
        outcomes = []
        for e in range(eval_episodes):
            rec = None
            if record_every_n and e % record_every_n == 0:
                from manigaussian_tpu_torch.utils.video import EpisodeRecorder
                rec = EpisodeRecorder()
            outcomes.append(rollout_episode(
                agent, env, episode_offset + e, episode_length, sent, toks,
                with_length=True, recorder=rec))
            if rec is not None:
                rec.save(os.path.join(logdir, "videos",
                                      f"{task}_step{step}_ep{e}"))
        returns = [r for r, _ in outcomes]
        lengths = [s for _, s in outcomes]
        mean_r = float(np.mean(returns))
        per_task.append(mean_r)
        total_transitions += int(np.sum(lengths))
        if len(tasks) > 1:
            row[f"eval_envs/return/{task}"] = mean_r
            row[f"eval_envs/length/{task}"] = float(np.mean(lengths))
            row[f"eval_envs/total_transitions/{task}"] = float(
                total_transitions)
    if len(tasks) == 1:
        row["eval_envs/return"] = per_task[0]
    row["eval_envs/mean_return"] = float(np.mean(per_task))
    return row


def run_eval(agent: ManiGaussianBCAgent, logdir: str, env: EnvClient,
             tasks: Sequence[str], eval_type="last", eval_episodes: int = 25,
             episode_length: int = 25, lang_model=None,
             record_every_n: int = 0,
             episode_offset: int = 0) -> List[Dict[str, float]]:
    """Full eval pass, serial over the selected checkpoints; appends one
    eval_data.csv row per checkpoint. record_every_n > 0 saves a GIF of
    every n-th episode under <logdir>/videos/; episode_offset > 0 starts the
    rollouts at that stored-episode index (held-out eval)."""
    steps = select_checkpoints(logdir, eval_type, tasks)
    rows = []
    env.launch()
    try:
        for step in steps:
            row = evaluate_checkpoint(agent, logdir, step, env, tasks,
                                      eval_episodes, episode_length,
                                      lang_model,
                                      record_every_n=record_every_n,
                                      episode_offset=episode_offset)
            append_eval_csv(logdir, row)
            rows.append(row)
    finally:
        env.shutdown()
    return rows


def make_env(cfg, demo_root: str, env_kind: str) -> EnvClient:
    """`mock` (stored-demo replay), `rpc://HOST:PORT` (a simulator on
    another host, `python -m manigaussian_tpu_torch.sim_host_server`),
    `transcript://PATH` (a recorded session's conformance replay), anything
    else the RLBench simulator in this process."""
    if env_kind == "mock":
        from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
        return MockEnvClient(demo_root, cameras=cfg.rlbench.cameras,
                             episode_length=cfg.rlbench.episode_length)
    if env_kind.startswith("rpc://"):
        from manigaussian_tpu_torch.envs.rpc import RPCEnvClient
        return RPCEnvClient(env_kind)
    if env_kind.startswith("transcript://"):
        from manigaussian_tpu_torch.envs.transcript import TranscriptReplayEnv
        return TranscriptReplayEnv(env_kind.removeprefix("transcript://"))
    from manigaussian_tpu_torch.envs.rlbench_env import RLBenchEnvClient
    return RLBenchEnvClient(demo_root, cameras=cfg.rlbench.cameras,
                            episode_length=cfg.rlbench.episode_length)


def _eval_worker(payload):
    """Spawn-context worker: build agent, env and language model from the
    config on the payload's device ("cuda" or "cpu") and evaluate ONE
    checkpoint. Records no GIFs and reads
    `cfg.method.language_model_checkpoint`, as the JAX worker does."""
    (cfg, logdir, step, demo_root, env_kind, eval_episodes, device,
     episode_offset) = payload

    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model

    agent = create_agent(cfg, device=device)
    lang = create_language_model(
        cfg.method.language_model,
        checkpoint_dir=cfg.method.language_model_checkpoint,
        cache_dir=os.path.join(logdir, "lang_cache"), device=agent.device)
    env = make_env(cfg, demo_root, env_kind)
    env.launch()
    try:
        return evaluate_checkpoint(agent, logdir, step, env,
                                   cfg.rlbench.tasks, eval_episodes,
                                   cfg.rlbench.episode_length, lang,
                                   episode_offset=episode_offset)
    finally:
        env.shutdown()


def run_eval_parallel(cfg, logdir: str, demo_root: str, env_kind: str,
                      eval_type="missing", eval_episodes: int = 25,
                      num_workers: int = 2, device: Optional[str] = "cuda",
                      episode_offset: int = 0) -> List[Dict[str, float]]:
    """Evaluate the selected checkpoints concurrently, one task per
    checkpoint in a spawn-context pool of min(num_workers, checkpoints)
    processes (reference eval.py:154-172); in this process when
    num_workers <= 1 or one checkpoint is selected. The rows are sorted by
    step and the parent does every CSV write."""
    import multiprocessing as mp

    steps = select_checkpoints(logdir, eval_type, cfg.rlbench.tasks)
    if not steps:
        return []
    payloads = [(cfg, logdir, s, demo_root, env_kind, eval_episodes, device,
                 episode_offset)
                for s in steps]
    if num_workers <= 1 or len(steps) == 1:
        rows = [_eval_worker(p) for p in payloads]
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(num_workers, len(steps))) as pool:
            rows = pool.map(_eval_worker, payloads)
    rows.sort(key=lambda r: r["step"])
    for row in rows:
        append_eval_csv(logdir, row)
    return rows
