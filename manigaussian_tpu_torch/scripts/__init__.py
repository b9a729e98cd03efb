"""The user scripts of the JAX package's `scripts/`, ported: each has the JAX
script's file name and flags and runs as `python -m
manigaussian_tpu_torch.scripts.<name>` (on the GPU; `--cpu` on the CPU).

  gen_demonstrations    — stored demo episodes (synthetic, or live RLBench)
  flagship_campaign     — the whole system at flagship shapes for a real
                          training campaign (`scripts/r5_flagship_campaign.py`)
  make_results_artifact — train seeds → eval every checkpoint → per-seed
                          CSVs → `compute_results` aggregation
  diagnose_learning     — keyframe accuracy and rollouts at every checkpoint
  make_goldens          — the golden-frame fixtures, regenerated
"""
