"""Train entry point of the port: `python -m manigaussian_tpu_torch.train`.

Same flags and flow as the root `train.py` for one device: resolve the
config (variant, optional YAML, dotted overrides), optionally generate
synthetic demos, fill the replay from the stored demos, build the agent and
run the offline runner (auto-resume under
`framework.load_existing_weights`), one log dir per seed. With
`replay.use_disk` (the default) the replay lives under `replay.path` in the
native record store and a later run reuses it. The semantic tiers
(`foundation_model_name` set) build the frozen feature tower on the agent's
device and hand its GT-embed function to the batch iterator, whose prefetch
thread computes `gt_embed` for every batch; a resume rebuilds the tower
from its seed or its checkpoint file. Runs on the GPU; `--cpu` runs it on
the CPU instead.

Multi-device, with the JAX CLI's flags and meaning (one process a rank):
`--mesh D` shards the batch over D ranks (data parallel; `replay.batch_size`
is the global batch and must divide by D), `--mesh-tile T` shards the splat
renderer's image tiles over T ranks, both at once make a (D, T) mesh of D·T
ranks. Without `--dist` the CLI starts the D·T processes itself on a
localhost rendezvous; with `--dist HOST:PORT,NPROCS,PID` the user starts
each process (on any host) with its own PID. GPU ranks use NCCL, one GPU a
rank; ranks that share a card need `--backend gloo`; `--cpu` runs every
rank on the CPU over gloo. The step equals the one-process step on the
global batch. Each rank fills its own replay (`replay.path` + `_p<rank>`)
and language cache; rank 0 writes the demos, the logs, the CSV and the
checkpoints. At the end of a seed every process prints one `[train] run`
JSON line: its rank, whether its parameters equal every rank's bit for bit,
its device's peak memory and the kernel launches it made.

    python -m manigaussian_tpu_torch.train --variant w_geo \
        --demo-root /data/demos --logdir logs/open_drawer \
        rlbench.tasks=[open_drawer]
    python -m manigaussian_tpu_torch.train --mesh 2 --mesh-tile 2 ... \
        replay.batch_size=4
"""

from __future__ import annotations

import argparse
import json
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
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard batches over this many ranks (0 = one "
                             "process)")
    parser.add_argument("--mesh-tile", type=int, default=0,
                        help="shard the renderer's image tiles over this many "
                             "ranks inside the train step (0 = off)")
    parser.add_argument("--dist", default=None,
                        metavar="HOST:PORT,NPROCS,PID",
                        help="join a multi-process run as process PID of "
                             "NPROCS; start the SAME command for every PID")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="collective backend of GPU ranks (default "
                             "nccl; gloo for ranks that share a card)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from manigaussian_tpu_torch.utils.config_io import load_config
    cfg = load_config(args.config, args.overrides, variant=args.variant)
    world = max(1, args.mesh) * max(1, args.mesh_tile)
    if args.mesh and cfg.replay.batch_size % args.mesh:
        raise ValueError(f"replay.batch_size={cfg.replay.batch_size} does not "
                         f"divide by --mesh {args.mesh}")
    if args.dist:
        return _rank_main(args, cfg, args.dist)
    if args.mesh or args.mesh_tile:
        from manigaussian_tpu_torch.parallel import distributed
        if world == 1:
            return _rank_main(args, cfg, distributed.dist_spec(
                distributed.free_port(), 1, 0))
        distributed.spawn_local(_spawned, world, (world, args, cfg))
        return {}
    return _run_seeds(args, cfg)


def _run_seeds(args, cfg, device=None, mesh=None, tile_mesh=None):
    return {seed: _run_seed(args, cfg, seed, device, mesh, tile_mesh)
            for seed in range(args.seed,
                              args.seed + max(1, cfg.framework.seeds))}


def _spawned(rank, port, world, args, cfg):
    from manigaussian_tpu_torch.parallel import distributed
    _rank_main(args, cfg, distributed.dist_spec(port, world, rank))


def _rank_main(args, cfg, spec):
    """One rank: join the group, build the meshes as the JAX CLI does, run
    the seeds, leave the group."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.parallel import distributed
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    device = distributed.init_distributed(
        spec, "cpu" if args.cpu else "cuda", args.backend)
    world = dist.get_world_size()
    want = max(1, args.mesh) * max(1, args.mesh_tile)
    if world != want:
        raise ValueError(f"{world} processes for a mesh of {want} ranks")
    mesh = tile_mesh = None
    if args.mesh and args.mesh_tile:
        mesh = tile_mesh = make_mesh((args.mesh, args.mesh_tile),
                                     ("data", "tile"))
    elif args.mesh_tile:
        tile_mesh = make_mesh((args.mesh_tile,), ("tile",))
    elif args.mesh:
        mesh = make_mesh((args.mesh,), ("data",))
    try:
        results = _run_seeds(args, cfg, device, mesh, tile_mesh)
    finally:
        dist.destroy_process_group()
    return results


def _run_seed(args, cfg, seed, device=None, mesh=None, tile_mesh=None):
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.parallel import distributed
    from manigaussian_tpu_torch.runners.offline_train_runner import \
        OfflineTrainRunner
    from manigaussian_tpu_torch.utils.config_io import save_config

    rank = distributed.rank()
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
    if rank == 0:
        save_config(cfg, logdir)

    if args.synthetic and rank == 0:
        from manigaussian_tpu_torch.data.synthetic import generate_task
        for task in cfg.rlbench.tasks:
            if not os.path.isdir(os.path.join(args.demo_root, task)):
                generate_task(args.demo_root, task,
                              num_episodes=cfg.rlbench.demos,
                              h=cfg.rlbench.camera_resolution[0],
                              w=cfg.rlbench.camera_resolution[1],
                              nerf_hw=cfg.method.neural_renderer.image_height)
    # every rank fills its own replay and language cache from the demos
    distributed.barrier()
    suffix = f"_p{rank}" if distributed.is_initialized() else ""

    agent = create_agent(cfg, device=device or ("cpu" if args.cpu else None),
                         seed=seed, tile_mesh=tile_mesh)
    lang = create_language_model(
        cfg.method.language_model,
        checkpoint_dir=cfg.method.language_model_checkpoint,
        cache_dir=os.path.join(logdir, "lang_cache" + (suffix if rank else "")),
        device=agent.device)
    replay = TaskUniformReplay(
        save_dir=cfg.replay.path + suffix if cfg.replay.use_disk else None)
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
        replay.flush()
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
        result = OfflineTrainRunner(agent, batches, logdir, cfg, seed=seed,
                                    mesh=mesh or tile_mesh).start()
    finally:
        batches.close()
    _run_summary(agent)
    return result


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters (each counts its launches)."""
    from manigaussian_tpu_torch.ops import (blend, conv3d, flash_attention,
                                            fused_lamb)
    return {"flash_self_attention_fwd":
            flash_attention.flash_self_attention.launches,
            "flash_self_attention_bwd":
            flash_attention.flash_self_attention_backward.launches,
            "blend_fwd": blend.blend_forward.launches,
            "blend_bwd": blend.blend_backward.launches,
            "conv3d_fwd": conv3d.conv3d_forward.launches,
            "conv3d_dw": conv3d.conv3d_dw_workspace.launches,
            "conv3d_dw_resident": conv3d.conv3d_dw_resident.launches,
            "fused_lamb": fused_lamb.FusedLamb.launches}


def _run_summary(agent):
    """The process's JSON line: its rank, its parameters against every
    rank's bit for bit (None in a one-process run), its device's peak
    memory, its kernel launches."""
    import torch
    import torch.distributed as dist

    from manigaussian_tpu_torch.parallel import distributed
    dev = agent.device
    multi = distributed.is_initialized()
    print("[train] run " + json.dumps(
        {"rank": distributed.rank(),
         "world": dist.get_world_size() if multi else 1,
         "backend": dist.get_backend() if multi else None,
         "device": str(dev),
         "params_equal_across_ranks": (distributed.params_in_sync(
             list(agent.qfn.parameters())) if multi else None),
         "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None),
         "kernel_launches": kernel_launches()}), flush=True)


if __name__ == "__main__":
    main()
