"""A ManiGaussian_results-style eval artifact, end to end (counterpart of
`scripts/make_results_artifact.py`).

The reference record `ManiGaussian_results/w_geo/{0,1,2}.csv` holds per-seed
CSVs of per-task returns at each evaluated checkpoint, aggregated by
`compute_results --method last/best`. This script runs that whole chain on
synthetic multi-task demos with the mock env: train the seeds → evaluate
every checkpoint → per-seed CSVs → the `compute_results` aggregation.

  * the scenes carry distractor spheres (data/synthetic.py);
  * eval is held out: training fills the replay from episodes 0-1, eval
    rolls out episodes 2-5 (`episode_offset`);
  * checkpoints every `--save-freq` steps, so the success curve's rise is
    in the CSVs;
  * every launch tier trains (`--variants`), each into <out>/<variant>/.

The configuration is `config.micro_variant` (tiny widths, the tier's losses
intact; its policy runs in fp32, so the flash kernels' fp32 instances carry
its 8-wide heads). Its renderer chunk stays 32: the port's blend kernels
take any chunk (the JAX script raises it to 128 on the TPU for Pallas'
lanes only). Training and the eval workers run on the GPU unless `--cpu`:
the workers are spawned processes, each with its own CUDA context.

Output per variant: `<seed>.csv` (step + the per-task column triple
`eval_envs/{return,length,total_transitions}/<task>` and
`eval_envs/mean_return`), `train_<seed>.csv`, `config.json` and
`summary.json` ({"last"|"best": {"mean", "std", "per_seed"}}).

Usage:
    python -m manigaussian_tpu_torch.scripts.make_results_artifact \\
        --out results/synthetic_micro_torch \\
        --variants w_geo w_geo_dyna w_geo_sem w_geo_sem_dyna
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil

TASKS = ["open_drawer", "turn_tap", "push_buttons"]
HELD_OUT_EPISODES = 4  # eval rolls out episodes [demos, demos+4)


def _write_rows(path: str, rows) -> None:
    """The rows as a CSV, columns in first-seen order (an absent cell
    empty), floats as Python writes them."""
    fields = []
    for r in rows:
        fields += [k for k in r if k not in fields]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)


def run(out_dir: str, variant: str = "w_geo", seeds: int = 3,
        tasks=tuple(TASKS), iterations: int = 3000,
        save_freq: int = 250, episodes: int = HELD_OUT_EPISODES,
        workers: int = 2, demo_root: str | None = None,
        work_dir: str | None = None, device=None) -> dict:
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.analysis.compute_results import aggregate
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.runners.eval_runner import (read_eval_csv,
                                                            run_eval_parallel)
    from manigaussian_tpu_torch.utils.config_io import save_config
    from manigaussian_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    work_dir = work_dir or os.path.join(out_dir, "_work")
    demo_root = demo_root or os.path.join(work_dir, "demos")
    os.makedirs(out_dir, exist_ok=True)

    # the micro config: the lr/batch overrides make LAMB converge inside the
    # micro budget (micro_variant's docstring, scripts/diagnose_learning.py)
    cfg = C.micro_variant(variant, tasks, iterations, save_freq)
    h, w = cfg.rlbench.camera_resolution
    img = cfg.method.neural_renderer.image_height
    for i, task in enumerate(tasks):
        if not os.path.isdir(os.path.join(demo_root, task)):
            # 2 train episodes (cfg.rlbench.demos) + held-out eval episodes,
            # with distractor spheres on (generate_task's default)
            generate_task(demo_root, task,
                          num_episodes=cfg.rlbench.demos + HELD_OUT_EPISODES,
                          timesteps=12, h=h, w=w, nerf_views=3, nerf_hw=img,
                          seed=i)

    seed_csvs = []
    for seed in range(seeds):
        logdir = os.path.join(work_dir, "logs", f"seed{seed}")
        if not os.path.isdir(os.path.join(logdir, "weights")):
            train_cli._run_seed(
                argparse.Namespace(cpu=False, synthetic=False,
                                   demo_root=demo_root,
                                   logdir=os.path.join(work_dir, "logs")),
                cfg, seed, device=device)
        save_config(cfg, logdir)
        eval_cfg = dataclasses.replace(
            cfg, method=dataclasses.replace(cfg.method,
                                            use_neural_rendering=False))
        run_eval_parallel(eval_cfg, logdir, demo_root, "mock",
                          eval_type="missing", eval_episodes=episodes,
                          num_workers=workers, device=device.type,
                          episode_offset=cfg.rlbench.demos)
        rows = read_eval_csv(logdir)
        csv_path = os.path.join(out_dir, f"{seed}.csv")
        _write_rows(csv_path, rows)
        seed_csvs.append(csv_path)
        # the training curve beside the eval record
        train_csv = os.path.join(logdir, "train_data.csv")
        if os.path.exists(train_csv):
            shutil.copyfile(train_csv,
                            os.path.join(out_dir, f"train_{seed}.csv"))
        cfg_json = os.path.join(logdir, "config.json")
        if seed == 0 and os.path.exists(cfg_json):
            shutil.copyfile(cfg_json, os.path.join(out_dir, "config.json"))
        print(f"[artifact] {variant} seed {seed}: {len(rows)} checkpoints "
              f"-> {csv_path}")

    summary = {}
    for method in ("last", "best"):
        mean, std, per_seed = aggregate(seed_csvs, method)
        summary[method] = {"mean": mean, "std": std, "per_seed": per_seed}
        print(f"[compute_results --method {method}] {variant} "
              f"avg return over seeds: {mean:.2f} ± {std:.2f}")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="results/synthetic_micro_torch")
    parser.add_argument("--variants", nargs="+", default=["w_geo"],
                        help="launch tiers to train+eval (each lands in "
                             "<out>/<variant>/)")
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--iterations", type=int, default=3000)
    parser.add_argument("--save-freq", type=int, default=250)
    parser.add_argument("--episodes", type=int, default=HELD_OUT_EPISODES,
                        help="held-out eval episodes per task (indices "
                             "demos..demos+N-1, never in the replay)")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--keep-work", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="train and evaluate on the CPU instead of the "
                             "GPU")
    args = parser.parse_args(argv)
    from manigaussian_tpu_torch.utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    summaries = {}
    for variant in args.variants:
        out = os.path.join(args.out, variant)
        summaries[variant] = run(
            out, variant=variant, seeds=args.seeds,
            iterations=args.iterations, save_freq=args.save_freq,
            episodes=args.episodes, workers=args.workers, device=device)
        if not args.keep_work:
            shutil.rmtree(os.path.join(out, "_work"), ignore_errors=True)
    return summaries


if __name__ == "__main__":
    main()
