"""Eval entry point of the port: `python -m manigaussian_tpu_torch.eval`.

Same flags and flow as the root `eval.py`: reload the saved config from the
log dir, switch neural rendering off, select checkpoints (missing / best /
last / <int>), roll out `--episodes` per task on the mock env, append
eval_data.csv. Runs on the GPU; `--cpu` runs it on the CPU instead.

    python -m manigaussian_tpu_torch.eval --logdir logs/run/seed0 \
        --demo-root /data/demos --eval-type last --episodes 25
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--logdir", required=True)
    parser.add_argument("--demo-root", required=True)
    parser.add_argument("--env", default="mock", choices=["mock"],
                        help="mock (stored-demo replay); the simulator and "
                             "RPC envs are not ported yet")
    parser.add_argument("--eval-type", default="last",
                        help="missing | best | last | <int checkpoint>")
    parser.add_argument("--episodes", type=int, default=25)
    parser.add_argument("--episode-offset", type=int, default=0,
                        help="start rollouts at this stored-episode index")
    parser.add_argument("--episode-length", type=int, default=25,
                        help="max steps per rollout (reference conf/eval.yaml"
                             ":9 uses 25; training config default is 15)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.runners.eval_runner import make_env, run_eval
    from manigaussian_tpu_torch.utils.config_io import (from_dict,
                                                        load_saved_config,
                                                        parse_overrides)

    cfg = load_saved_config(args.logdir)
    if args.overrides:
        cfg = from_dict(parse_overrides(args.overrides), cfg)
    # eval suppresses neural rendering (eval.py:55-57) and uses the eval
    # episode_length (25), not the training one (15)
    cfg = dataclasses.replace(
        cfg,
        method=dataclasses.replace(cfg.method, use_neural_rendering=False),
        rlbench=dataclasses.replace(cfg.rlbench,
                                    episode_length=args.episode_length))
    eval_type = (int(args.eval_type) if args.eval_type.isdigit()
                 else args.eval_type)

    agent = create_agent(cfg, device="cpu" if args.cpu else None)
    lang = create_language_model(cfg.method.language_model,
                                 cache_dir=os.path.join(args.logdir,
                                                        "lang_cache"))
    env = make_env(cfg, args.demo_root, args.env)
    rows = run_eval(agent, args.logdir, env, cfg.rlbench.tasks,
                    eval_type=eval_type, eval_episodes=args.episodes,
                    episode_length=cfg.rlbench.episode_length,
                    lang_model=lang, episode_offset=args.episode_offset)
    for r in rows:
        print(r)
    return rows


if __name__ == "__main__":
    main()
