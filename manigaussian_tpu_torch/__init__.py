"""manigaussian_tpu_torch — the PyTorch/CUDA port of `manigaussian_tpu`.

The JAX package beside it is the reference; this package imports torch and
numpy, never jax, flax, optax or anything of `manigaussian_tpu`. Its module
paths mirror the JAX package's so each counterpart is easy to find:

  ops/     — camera unprojection, voxelizer, rotation codec, bilinear
             resize, the rasterizer, and the hand-written CUDA kernels'
             wrappers (flash attention, tile blend, 3³ conv; csrc/)
  models/  — conv blocks, 3D U-Net, Perceiver IO policy encoder, Gaussian
             regressor, the semantic tiers' frozen towers (SD VAE, DINOv2)
             and their ground-truth embedding (foundation.py)
  agents/  — QFunction (policy part), BC agent `act`, method registry
  data/    — stored-demo episodes, keypoints, synthetic demos, language stub
             and towers, the replay (in memory, native record store —
             native/replay_store.cpp — or pickles) and batch pipeline
  envs/    — env-client protocol, mock replay env, RPC bridge, recorded
             transcripts, RLBench client
  runners/ — eval runner (checkpoint selection, rollouts and GIFs, eval CSV,
             checkpoint workers), training runner
  utils/   — device selection, config IO, torch checkpoints, optimizers,
             episode recorder
  convert  — JAX parameter tree → this package's state_dict
  train, eval, bench, sim_host_server — the entry points (`python -m`)

Entry points run on `cuda`; they run on the CPU only when the caller asks
(`device="cpu"`, `--cpu`).
"""

__version__ = "0.1.0"

from manigaussian_tpu_torch import config  # noqa: F401  (public config tree)
