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
  envs/    — env-client protocol, mock replay env
  runners/ — eval runner (checkpoint selection, rollouts, eval CSV)
  utils/   — device selection, config IO, torch checkpoints
  convert  — JAX parameter tree → this package's state_dict

Entry points run on `cuda`; they run on the CPU only when the caller asks
(`device="cpu"`, `--cpu`).
"""

__version__ = "0.1.0"

from manigaussian_tpu_torch import config  # noqa: F401  (public config tree)
