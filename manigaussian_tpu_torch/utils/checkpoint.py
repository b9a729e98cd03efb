"""Torch checkpoints under the log dir: save, list, restore, rolling window.

Same directory convention as `manigaussian_tpu/utils/checkpoint.py`
(`<logdir>/weights/<step>/`), so eval's missing/best/last selection reads
both alike. A checkpoint holds the module's `state_dict` (`state_dict.pt`)
and, from training, the optimizer's state with its update count
(`optimizer.pt`; restoring it into the other optimizer raises),
so a resume is exact; the resolved config sits beside the weights as
`<logdir>/config.json`. The rolling window keeps the newest
`num_weights_to_keep` (0 keeps all).
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import torch

from manigaussian_tpu_torch.utils.config_io import save_config

STATE_FILE = "state_dict.pt"
OPT_FILE = "optimizer.pt"
# parameters a policy-only module (eval) may leave out of a training checkpoint
RENDERER_PREFIX = "neural_renderer."


def _weights_dir(logdir: str) -> str:
    return os.path.join(logdir, "weights")


def list_checkpoints(logdir: str) -> List[int]:
    d = _weights_dir(logdir)
    if not os.path.isdir(d):
        return []
    return sorted(int(name) for name in os.listdir(d)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(d, name, STATE_FILE)))


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(logdir: str, step: int, module: torch.nn.Module,
                    cfg=None, optimizer=None,
                    num_weights_to_keep: int = 0) -> str:
    """Write `module.state_dict()` (moved to the CPU) for `step`; with
    `optimizer`, also its state; with `cfg`, (re)write
    `<logdir>/config.json`. Then drop all but the newest
    `num_weights_to_keep` checkpoints (0 keeps all)."""
    path = os.path.join(_weights_dir(logdir), str(step))
    os.makedirs(path, exist_ok=True)
    _save({k: v.detach().cpu() for k, v in module.state_dict().items()},
          os.path.join(path, STATE_FILE))
    if optimizer is not None:
        _save(optimizer.state_dict(), os.path.join(path, OPT_FILE))
    if cfg is not None:
        save_config(cfg, logdir)
    if num_weights_to_keep:
        for old in list_checkpoints(logdir)[:-num_weights_to_keep]:
            shutil.rmtree(os.path.join(_weights_dir(logdir), str(old)),
                          ignore_errors=True)
    return path


def restore_checkpoint(logdir: str, module: torch.nn.Module,
                       step: Optional[int] = None, optimizer=None
                       ) -> Tuple[Optional[torch.nn.Module], Optional[int]]:
    """Load a checkpoint into `module` (and `optimizer`, when given and
    saved) in place. step=None → latest. A module without the renderer
    (eval) loads a training checkpoint's policy and leaves the renderer's
    parameters out; any other missing or unexpected key raises.

    Returns (module, step), or (None, None) when there is nothing to load.
    """
    steps = list_checkpoints(logdir)
    if not steps:
        return None, None
    step = steps[-1] if step is None else step
    path = os.path.join(_weights_dir(logdir), str(step))
    if not os.path.isfile(os.path.join(path, STATE_FILE)):
        return None, None
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    missing, unexpected = module.load_state_dict(state, strict=False)
    unexpected = [k for k in unexpected if not k.startswith(RENDERER_PREFIX)]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the module: "
                           f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    opt_path = os.path.join(path, OPT_FILE)
    if optimizer is not None and os.path.isfile(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location="cpu",
                                             weights_only=True))
    return module, step
