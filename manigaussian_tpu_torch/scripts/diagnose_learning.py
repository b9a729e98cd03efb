"""Why does an eval artifact show 0 % at the last checkpoint? (counterpart
of `scripts/diagnose_learning.py`).

Separates three hypotheses:
  A. the policy never learns the training set (a training-side fault),
  B. it learns, but the act() decode or the eval observations disagree
     with training (keyframe accuracy high, rollouts zero),
  C. it learns, then degrades with more training (optimization).

Method: micro-train one seed on synthetic tasks (the config of
make_results_artifact), and at every checkpoint measure
  * train-set keyframe accuracy: act() on the replay's stored observations
    against the stored labels (trans voxel index exact and within one
    voxel, gripper state),
  * mock-env rollout return with the train description ("open drawer demo")
    and the eval description ("open drawer").

Writes <work>/report.json (one row per checkpoint). Runs on the GPU; `--cpu`
runs it on the CPU.

Usage:
    python -m manigaussian_tpu_torch.scripts.diagnose_learning \\
        --iterations 1200 --save-freq 200
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def micro_cfg(tasks, iterations, save_freq, batch_size=4, lr=2e-3):
    from manigaussian_tpu_torch import config as C
    return C.micro_w_geo(tasks, iterations, save_freq, batch_size, lr)


def keyframe_accuracy(agent, replay):
    """act() on every stored transition's observation (the agent's current
    weights); exact and within-1-voxel trans match and grip match."""
    import numpy as np

    from manigaussian_tpu_torch.data.pipeline import assemble_batch

    rng = np.random.default_rng(0)
    n = exact = near = grip_ok = 0
    for task in replay.tasks:
        for i in range(replay.size(task)):
            tr = replay._get(task, i)
            batch = assemble_batch([tr], rng, load_nerf_targets=False)
            obs = {k: batch[k] for k in ("rgb", "pcd", "low_dim_state",
                                         "lang_goal_emb", "lang_token_embs")}
            res = agent.act(obs)
            pred = np.asarray(res.trans_coords[0].cpu())
            gt = np.asarray(tr["trans_action_indicies"][:3])
            exact += int((pred == gt).all())
            near += int((np.abs(pred - gt) <= 1).all())
            g_pred = int(res.rot_grip_indices[0, 3])
            grip_ok += int(g_pred == int(tr["rot_grip_action_indicies"][3]))
            n += 1
    return dict(n=n, trans_exact=exact / n, trans_near=near / n,
                grip=grip_ok / n)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=1200)
    p.add_argument("--save-freq", type=int, default=200)
    p.add_argument("--tasks", nargs="*", default=["open_drawer"])
    p.add_argument("--work", default=os.path.join("build", "diag_learning"))
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the GPU")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
    from manigaussian_tpu_torch.runners.eval_runner import rollout_episode
    from manigaussian_tpu_torch.runners.offline_train_runner import \
        OfflineTrainRunner
    from manigaussian_tpu_torch.utils.checkpoint import (list_checkpoints,
                                                         restore_checkpoint)
    from manigaussian_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = micro_cfg(args.tasks, args.iterations, args.save_freq)
    demo_root = os.path.join(args.work, "demos")
    logdir = os.path.join(args.work, "logs", "seed0")
    for i, task in enumerate(cfg.rlbench.tasks):
        if not os.path.isdir(os.path.join(demo_root, task)):
            generate_task(demo_root, task, num_episodes=cfg.rlbench.demos,
                          timesteps=12, h=16, w=16, nerf_views=3, nerf_hw=32,
                          seed=i)

    lang = create_language_model(cfg.method.language_model,
                                 cache_dir=os.path.join(logdir, "lang_cache"))
    replay = TaskUniformReplay()
    for task in cfg.rlbench.tasks:
        n = fill_replay(replay, demo_root, task, cfg.rlbench.demos,
                        cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                        cfg.method.voxel_sizes[0],
                        cfg.method.rotation_resolution,
                        cfg.rlbench.episode_length, lang)
        print(f"[replay] {task}: {n} transitions")

    if not list_checkpoints(logdir):
        batches = BatchIterator(replay, cfg.replay.batch_size, seed=0,
                                load_nerf_targets=True)
        agent = create_agent(cfg, device=device)
        try:
            OfflineTrainRunner(agent, batches, logdir, cfg, seed=0).start()
        finally:
            batches.close()

    eval_cfg = dataclasses.replace(
        cfg, method=dataclasses.replace(cfg.method,
                                        use_neural_rendering=False))
    agent = create_agent(eval_cfg, device=device)
    env = MockEnvClient(demo_root, cameras=cfg.rlbench.cameras,
                        episode_length=cfg.rlbench.episode_length)
    env.launch()

    report = []
    try:
        for step in list_checkpoints(logdir):
            restore_checkpoint(logdir, agent.qfn, step=step)
            with torch.no_grad():
                row = {"step": step, **keyframe_accuracy(agent, replay)}
                for desc_kind in ("train", "eval"):
                    rets, lens = [], []
                    for task in cfg.rlbench.tasks:
                        env.set_task(task)
                        text = (f"{task.replace('_', ' ')} demo"
                                if desc_kind == "train"
                                else task.replace("_", " "))
                        sent, toks = lang.encode(text)
                        for e in range(args.episodes):
                            r, s = rollout_episode(
                                agent, env, e, cfg.rlbench.episode_length,
                                sent, toks, with_length=True)
                            rets.append(r)
                            lens.append(s)
                    row[f"return_{desc_kind}"] = float(np.mean(rets))
                    row[f"len_{desc_kind}"] = float(np.mean(lens))
            report.append(row)
            print(json.dumps(row), flush=True)
    finally:
        env.shutdown()

    out = os.path.join(args.work, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[diag] wrote {out}")
    return report


if __name__ == "__main__":
    main()
