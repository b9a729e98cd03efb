"""Torch checkpoints under the log dir: save, list, restore.

Same directory convention as `manigaussian_tpu/utils/checkpoint.py`
(`<logdir>/weights/<step>/`), so eval's missing/best/last selection reads
both alike; the payload is a torch `state_dict` (`state_dict.pt`) and the
resolved config sits beside the weights as `<logdir>/config.json`. The
rolling window and optimizer state arrive with the training slice.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from manigaussian_tpu_torch.utils.config_io import save_config

STATE_FILE = "state_dict.pt"


def _weights_dir(logdir: str) -> str:
    return os.path.join(logdir, "weights")


def list_checkpoints(logdir: str) -> List[int]:
    d = _weights_dir(logdir)
    if not os.path.isdir(d):
        return []
    return sorted(int(name) for name in os.listdir(d)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(d, name, STATE_FILE)))


def save_checkpoint(logdir: str, step: int, module: torch.nn.Module,
                    cfg=None) -> str:
    """Write `module.state_dict()` (moved to the CPU) for `step`; with `cfg`,
    also (re)write `<logdir>/config.json`."""
    path = os.path.join(_weights_dir(logdir), str(step))
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if cfg is not None:
        save_config(cfg, logdir)
    return path


def restore_checkpoint(logdir: str, module: torch.nn.Module,
                       step: Optional[int] = None
                       ) -> Tuple[Optional[torch.nn.Module], Optional[int]]:
    """Load a checkpoint into `module` in place. step=None → latest.

    Returns (module, step), or (None, None) when there is nothing to load.
    """
    steps = list_checkpoints(logdir)
    if not steps:
        return None, None
    step = steps[-1] if step is None else step
    path = os.path.join(_weights_dir(logdir), str(step), STATE_FILE)
    if not os.path.isfile(path):
        return None, None
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state)
    return module, step
