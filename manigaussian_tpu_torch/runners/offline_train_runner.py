"""Offline BC training loop (port of
`manigaussian_tpu/runners/offline_train_runner.py:67-162`; YARR
`offline_train_runner.py:157-234`).

Resume from the newest checkpoint (params, LAMB state, step) when
`load_existing_weights` is set, one `agent.update` per iteration, metrics to
the host only at `log_freq` (the one sync point of the loop), checkpoints
every `save_freq` with a rolling window, a last checkpoint at the end, and
every `render_freq` steps (step 0 too) the recon panel of the batch's
first target view (`agent.render_for_vis`, `utils/visualization`); a
failure of the panel is printed and never stops training.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
from manigaussian_tpu_torch.config import ManiGaussianConfig
from manigaussian_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
from manigaussian_tpu_torch.utils.logger import MetricLogger


class OfflineTrainRunner:
    def __init__(self, agent: ManiGaussianBCAgent, batch_iterator: Iterator,
                 logdir: str, cfg: ManiGaussianConfig, seed: int = 0):
        self.agent = agent
        self.batches = batch_iterator
        self.logdir = logdir
        self.cfg = cfg
        self.seed = seed
        self.logger = MetricLogger(logdir)

    def _save(self, step: int) -> None:
        save_checkpoint(self.logdir, step, self.agent.qfn, cfg=self.cfg,
                        optimizer=self.agent.optimizer(),
                        num_weights_to_keep=self.cfg.framework.num_weights_to_keep)

    def _recon_panel(self, step: int, batch) -> None:
        """The recon panel (qattention:921-1010); visualization must never
        stop training, so any failure is printed and passed over."""
        try:
            from manigaussian_tpu_torch.utils.visualization import \
                save_recon_panel
            res = self.agent.render_for_vis(batch)
            host = lambda x: None if x is None else x[0].float().cpu().numpy()
            first = lambda k: np.asarray(batch[k])[0] if k in batch else None
            save_recon_panel(
                self.logdir, step, input_rgb=np.asarray(batch["rgb"])[0, 0],
                gt_rgb=first("nerf_target_rgb"),
                pred_rgb=host(res.render_novel),
                pred_embed=host(res.render_embed), gt_embed=first("gt_embed"),
                next_pred_rgb=host(res.next_render_novel),
                next_gt_rgb=first("nerf_next_target_rgb"))
        except Exception as e:  # visualization must never stop training
            print(f"[train] recon panel failed at {step}: {e!r}", flush=True)

    def start(self, max_iterations: Optional[int] = None) -> Dict[str, float]:
        """Train to `max_iterations` (default `training_iterations`);
        returns the last logged metrics."""
        fw = self.cfg.framework
        total_iters = max_iterations or fw.training_iterations
        start_iter = 0
        if fw.load_existing_weights:
            restored, step = restore_checkpoint(self.logdir, self.agent.qfn,
                                                optimizer=self.agent.optimizer())
            if restored is not None:
                start_iter = step
                self.agent.step = self.agent.optimizer().count
                print(f"[train] resumed from iteration {step}", flush=True)

        gen = torch.Generator().manual_seed(self.seed + 1)
        host: Dict[str, float] = {}
        t_last = time.perf_counter()
        for i in range(start_iter, total_iters):
            try:
                batch = next(self.batches)
            except StopIteration:
                break
            metrics = self.agent.update(batch, gen)
            if i % fw.log_freq == 0:
                host = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                host["steps_per_s"] = (fw.log_freq if i else 1) / max(dt, 1e-9)
                t_last = time.perf_counter()
                self.logger.log(i, host)
                self.logger.flush()
                print(MetricLogger.format_console(i, host), flush=True)
            if i and i % fw.save_freq == 0:
                self._save(i)
            render_freq = self.cfg.method.neural_renderer.render_freq
            if (self.cfg.method.use_neural_rendering and render_freq
                    and i % render_freq == 0 and "nerf_target_rgb" in batch):
                self._recon_panel(i, batch)
        self._save(total_iters - 1)
        self.logger.flush()
        return host
