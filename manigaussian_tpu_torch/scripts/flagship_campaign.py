"""Flagship-shape training campaign (counterpart of
`scripts/r5_flagship_campaign.py`).

The whole system together at flagship shapes — data generation, the input
pipeline, the kernels, the model, checkpoints and recon panels — for a real
training campaign, and the evidence it leaves:

  1. `gen`   — the multi-task synthetic dataset at flagship resolution
     (data/synthetic.py): 128² front camera, 21 nerf ring views at 128² per
     frame, `--demos` episodes × 3 tasks of 20 steps; the tasks are
     generated in parallel processes, each from its own seed (the JAX
     script's episodes, file for file).
  2. `feed`  — the host input pipeline's rate at these shapes: batches/s of
     `BatchIterator` over a replay of the same demos, against the step.
  3. `train` — the campaign through the production train path
     (`train._run_seed` → `OfflineTrainRunner`): loss / PSNR curves every
     `log_freq`, recon panels every `render_freq`, overflow counters,
     rolling checkpoints. `w_geo_sem*` runs the SD VAE from `random-init`.
  4. `collect` — the artifact directory (`--out`/<variant>/): the curve
     CSV (a resumed run's segment merged into the earlier one), the first,
     middle and last recon panels, the config, and summary.json with the
     JAX script's keys (non-finite cells, the PSNR trajectory, overflow
     maxima, steps/s, the feed rate).

The dataset, replay and logs live under `--work` (default
build/flagship_campaign); only the small artifact lands in `--out`
(default results/flagship_campaign_torch; the JAX run's artifact is
results/flagship_campaign and stays its own). Runs on the GPU; `--cpu` runs
it on the CPU (hours at these shapes). Trailing `key=value` arguments
override the campaign's config (e.g. `framework.log_freq=10`).

Usage:
    python -m manigaussian_tpu_torch.scripts.flagship_campaign \\
        --variant w_geo --iters 2010
    python -m manigaussian_tpu_torch.scripts.flagship_campaign \\
        --variant w_geo_sem_dyna --iters 3010
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import math
import os
import shutil
import time

import numpy as np

TASKS = ["open_drawer", "turn_tap", "push_buttons"]
WORK = os.path.join("build", "flagship_campaign")
OUT = os.path.join("results", "flagship_campaign_torch")

# flagship data shapes (conf: rlbench.camera_resolution 128², num_view_for_nerf
# 21, demos 20)
H = W = 128
NERF_VIEWS = 21
TIMESTEPS = 20
DEMOS = 20


def _gen_task(demo_root: str, task: str, demos: int) -> str:
    from manigaussian_tpu_torch.data.synthetic import generate_task
    generate_task(demo_root, task, num_episodes=demos, timesteps=TIMESTEPS,
                  h=H, w=W, nerf_views=NERF_VIEWS, nerf_hw=H,
                  seed=TASKS.index(task))
    return task


def gen_dataset(demo_root: str, demos: int = DEMOS) -> float:
    """The tasks not yet under `demo_root`, one spawned process each.
    Returns the wall time."""
    import multiprocessing as mp
    t0 = time.perf_counter()
    todo = [t for t in TASKS if not os.path.isdir(os.path.join(demo_root, t))]
    if todo:
        with mp.get_context("spawn").Pool(len(todo)) as pool:
            for task in pool.starmap(_gen_task,
                                     [(demo_root, t, demos) for t in todo]):
                print(f"[gen] {task}: {demos} episodes", flush=True)
    return time.perf_counter() - t0


def build_cfg(variant: str, iters: int, resume: bool = False,
              work: str = WORK, overrides=(), demos: int = DEMOS):
    from manigaussian_tpu_torch.utils.config_io import load_config
    base = (["framework.load_existing_weights=true"] if resume else []) + [
        f"rlbench.tasks=[{','.join(TASKS)}]",
        f"rlbench.demos={demos}",
        f"framework.training_iterations={iters}",
        "framework.log_freq=50",
        "framework.save_freq=2500",
        "framework.num_weights_to_keep=8",
        "method.neural_renderer.render_freq=1000",
        f"replay.path={work}/replay_{variant}",
    ]
    if variant in ("w_geo_sem", "w_geo_sem_dyna"):
        # the SD VAE's real compute path from seeded weights (no download)
        base.append("method.neural_renderer.foundation_checkpoint=random-init")
    return load_config(None, base + list(overrides), variant=variant)


def measure_feed_rate(cfg, demo_root: str, n_batches: int = 40,
                      work: str = WORK) -> dict:
    """Host-side BatchIterator throughput at flagship shapes (no device)."""
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay

    lang = create_language_model(cfg.method.language_model,
                                 cache_dir=os.path.join(work, "lang_cache"))
    replay = TaskUniformReplay(save_dir=None)
    n = 0
    for task in cfg.rlbench.tasks:
        n += fill_replay(
            replay, demo_root, task, cfg.rlbench.demos, cfg.rlbench.cameras,
            cfg.rlbench.scene_bounds, cfg.method.voxel_sizes[0],
            cfg.method.rotation_resolution, cfg.rlbench.episode_length, lang,
            demo_augmentation=cfg.method.demo_augmentation,
            demo_augmentation_every_n=cfg.method.demo_augmentation_every_n,
            keypoint_method=cfg.method.keypoint_method)
    it = BatchIterator(replay, cfg.replay.batch_size, seed=0,
                       num_view_for_nerf=cfg.method.num_view_for_nerf,
                       load_nerf_targets=True)
    next(it)  # warm (thread started, first assemble done)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        next(it)
    dt = time.perf_counter() - t0
    it.close()
    rate = n_batches / dt
    print(f"[feed] {n} transitions; {rate:.1f} batches/s "
          f"({dt / n_batches * 1e3:.1f} ms/batch) at batch "
          f"{cfg.replay.batch_size}", flush=True)
    return {"transitions": n, "batches_per_s": round(rate, 2),
            "ms_per_batch": round(dt / n_batches * 1e3, 2),
            "batch_size": cfg.replay.batch_size}


def train(cfg, variant: str, demo_root: str, work: str = WORK,
          device=None) -> str:
    from manigaussian_tpu_torch import train as train_cli
    logdir_root = os.path.join(work, "logs", variant)
    args = argparse.Namespace(cpu=False, synthetic=False, demo_root=demo_root,
                              logdir=logdir_root)
    train_cli._run_seed(args, cfg, 0, device=device)
    return os.path.join(logdir_root, "seed0")


def _read_csv(path: str):
    with open(path, newline="") as f:
        r = csv.DictReader(f)
        return list(r.fieldnames or []), list(r)


def _number(cell) -> float:
    try:
        return float(cell)
    except (TypeError, ValueError):
        return math.nan


def _merge_curve(train_csv: str, out_csv: str) -> None:
    """A resumed run logs a fresh train_data.csv from its start iteration:
    its rows replace the collected curve's rows of the same steps."""
    if not os.path.exists(out_csv):
        shutil.copyfile(train_csv, out_csv)
        return
    old_fields, old = _read_csv(out_csv)
    new_fields, new = _read_csv(train_csv)
    steps = {_number(r["step"]) for r in new}
    rows = [r for r in old if _number(r["step"]) not in steps] + new
    rows.sort(key=lambda r: _number(r["step"]))
    fields = old_fields + [k for k in new_fields if k not in old_fields]
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)


def _columns(path: str) -> dict:
    """The CSV's columns as float arrays (an empty cell is NaN), in file
    order."""
    fields, rows = _read_csv(path)
    return {k: np.array([_number(r.get(k)) for r in rows], np.float64)
            for k in fields}


def _mean(x: np.ndarray) -> float:
    x = x[~np.isnan(x)]
    return float(x.mean()) if x.size else math.nan


def collect(variant: str, logdir: str, feed: dict, gen_s: float,
            wall_s: float, out_root: str = OUT) -> dict:
    out = os.path.join(out_root, variant)
    os.makedirs(out, exist_ok=True)
    out_csv = os.path.join(out, "train.csv")
    _merge_curve(os.path.join(logdir, "train_data.csv"), out_csv)
    cfg_json = os.path.join(logdir, "config.json")
    if os.path.exists(cfg_json):
        shutil.copyfile(cfg_json, os.path.join(out, "config.json"))
    panels = sorted(glob.glob(os.path.join(logdir, "recon", "*.png")),
                    key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    # keep the first / middle / last panels (the artifact stays small)
    keep = {0, len(panels) // 2, len(panels) - 1} if panels else set()
    for idx in sorted(keep):
        shutil.copyfile(panels[idx],
                        os.path.join(out, os.path.basename(panels[idx])))

    df = _columns(out_csv)   # the merged curve (every resume segment)
    n = len(df["step"])
    k = max(3, n // 10)
    head = {c: v[:k] for c, v in df.items()}
    tail = {c: v[-k:] for c, v in df.items()}
    loss_cols = [c for c in df if c.endswith("_loss")]
    cells = np.stack(list(df.values())) if df else np.zeros((0,))
    sps = df["steps_per_s"][1:]
    summary = {
        "variant": variant,
        "iterations": int(df["step"][-1]) + 1,
        "logged_rows": n,
        "nonfinite_cells": int((~np.isfinite(cells)).sum()),
        "steps_per_s_median": round(float(np.nanmedian(sps)), 3)
        if sps.size else math.nan,
        "gen_dataset_s": round(gen_s, 1),
        "train_wall_s": round(wall_s, 1),
        "feed": feed,
        "losses_first_decile_mean": {c: round(_mean(head[c]), 5)
                                     for c in loss_cols},
        "losses_last_decile_mean": {c: round(_mean(tail[c]), 5)
                                    for c in loss_cols},
    }
    if "psnr" in df:
        summary["psnr_first"] = round(float(df["psnr"][0]), 2)
        summary["psnr_first_decile_mean"] = round(_mean(head["psnr"]), 2)
        summary["psnr_last_decile_mean"] = round(_mean(tail["psnr"]), 2)
        summary["psnr_max"] = round(float(np.nanmax(df["psnr"])), 2)
    for c in ("overflow_splats", "overflow_gaussians"):
        if c in df:
            summary[c + "_max"] = float(np.nanmax(df[c]))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="w_geo")
    parser.add_argument("--iters", type=int, default=10010)
    parser.add_argument("--skip-feed", action="store_true")
    parser.add_argument("--demos", type=int, default=DEMOS)
    parser.add_argument("--resume", action="store_true",
                        help="continue a previous campaign run from its last "
                             "checkpoint (framework.load_existing_weights)")
    parser.add_argument("--work", default=WORK,
                        help="dataset, replay and logs")
    parser.add_argument("--out", default=OUT,
                        help="artifact root (<out>/<variant>/)")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the GPU")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from manigaussian_tpu_torch.utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.work, exist_ok=True)
    demo_root = os.path.join(args.work, "demos")
    gen_s = gen_dataset(demo_root, args.demos)

    cfg = build_cfg(args.variant, args.iters, resume=args.resume,
                    work=args.work, overrides=args.overrides,
                    demos=args.demos)
    feed = {} if args.skip_feed else measure_feed_rate(cfg, demo_root,
                                                       work=args.work)
    t0 = time.perf_counter()
    logdir = train(cfg, args.variant, demo_root, args.work, device)
    wall_s = time.perf_counter() - t0
    return collect(args.variant, logdir, feed, gen_s, wall_s, args.out)


if __name__ == "__main__":
    main()
