"""Train entry point of the port: `python -m manigaussian_tpu_torch.train`.

Same flags and flow as the root `train.py` for one device: resolve the
config (variant, optional YAML, dotted overrides), optionally generate
synthetic demos, fill the replay from the stored demos, build the agent and
run the offline runner (auto-resume under
`framework.load_existing_weights`), one log dir per seed. The semantic tiers
(`foundation_model_name` set) build the frozen feature tower on the agent's
device and hand its GT-embed function to the batch iterator, whose prefetch
thread computes `gt_embed` for every batch; a resume rebuilds the tower
from its seed or its checkpoint file. Runs on the GPU; `--cpu` runs it on
the CPU instead. The JAX entry point's `--mesh`, `--mesh-tile` and `--dist`
(data and tile sharding, multi-host) are not ported.

    python -m manigaussian_tpu_torch.train --variant w_geo \
        --demo-root /data/demos --logdir logs/open_drawer \
        rlbench.tasks=[open_drawer]
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="w_geo",
                        help="w_geo | w_geo_dyna | w_geo_sem | w_geo_sem_dyna")
    parser.add_argument("--config", default=None, help="optional YAML config")
    parser.add_argument("--demo-root", required=True)
    parser.add_argument("--logdir", default="logs/run")
    parser.add_argument("--seed", type=int, default=0,
                        help="start seed; cfg.framework.seeds consecutive "
                             "seeds run one after the other, each in "
                             "<logdir>/seed<i>")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate synthetic demos into --demo-root first")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from manigaussian_tpu_torch.utils.config_io import load_config
    cfg = load_config(args.config, args.overrides, variant=args.variant)
    results = {}
    for seed in range(args.seed, args.seed + max(1, cfg.framework.seeds)):
        results[seed] = _run_seed(args, cfg, seed)
    return results


def _run_seed(args, cfg, seed):
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.runners.offline_train_runner import \
        OfflineTrainRunner
    from manigaussian_tpu_torch.utils.config_io import save_config

    random.seed(seed)
    np.random.seed(seed)
    logdir = os.path.join(args.logdir, f"seed{seed}")
    weights_dir = os.path.join(logdir, "weights")
    if os.path.isdir(weights_dir):
        done = sorted(int(w) for w in os.listdir(weights_dir) if w.isdigit())
        if done and done[-1] >= cfg.framework.training_iterations - 1:
            print(f"[train] seed {seed} already trained to {done[-1]} "
                  "iterations; skipping.", flush=True)
            return None
    os.makedirs(logdir, exist_ok=True)
    save_config(cfg, logdir)

    if args.synthetic:
        from manigaussian_tpu_torch.data.synthetic import generate_task
        for task in cfg.rlbench.tasks:
            if not os.path.isdir(os.path.join(args.demo_root, task)):
                generate_task(args.demo_root, task,
                              num_episodes=cfg.rlbench.demos,
                              h=cfg.rlbench.camera_resolution[0],
                              w=cfg.rlbench.camera_resolution[1],
                              nerf_hw=cfg.method.neural_renderer.image_height)

    agent = create_agent(cfg, device="cpu" if args.cpu else None, seed=seed)
    lang = create_language_model(
        cfg.method.language_model,
        checkpoint_dir=cfg.method.language_model_checkpoint,
        cache_dir=os.path.join(logdir, "lang_cache"), device=agent.device)
    replay = TaskUniformReplay(
        save_dir=cfg.replay.path if cfg.replay.use_disk else None)
    replay.reload_from_disk()
    if replay.size() == 0:
        for task in cfg.rlbench.tasks:
            n = fill_replay(
                replay, args.demo_root, task, cfg.rlbench.demos,
                cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                cfg.method.voxel_sizes[0], cfg.method.rotation_resolution,
                cfg.rlbench.episode_length, lang,
                demo_augmentation=cfg.method.demo_augmentation,
                demo_augmentation_every_n=cfg.method.demo_augmentation_every_n,
                keypoint_method=cfg.method.keypoint_method)
            print(f"[replay] {task}: {n} transitions", flush=True)
    embed_fn = None
    nr = cfg.method.neural_renderer
    if nr.foundation_model_name and cfg.method.use_neural_rendering:
        from manigaussian_tpu_torch.models.foundation import \
            create_feature_extractor
        extractor = create_feature_extractor(
            nr.foundation_model_name, nr.foundation_checkpoint,
            device=agent.device)
        embed_fn = extractor.embed_fn(nr.d_embed)
    batches = BatchIterator(replay, cfg.replay.batch_size, seed=seed,
                            num_view_for_nerf=cfg.method.num_view_for_nerf,
                            load_nerf_targets=cfg.method.use_neural_rendering,
                            embed_fn=embed_fn)
    try:
        return OfflineTrainRunner(agent, batches, logdir, cfg, seed=seed).start()
    finally:
        batches.close()


if __name__ == "__main__":
    main()
