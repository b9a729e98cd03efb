"""CSV / console metric logging (port of `manigaussian_tpu/utils/logger.py`;
YARR `log_writer.py`): CSV rows keyed by step with a lazily extended field
set, and the reference's console loss line."""

from __future__ import annotations

import csv
import os
from typing import Dict


class MetricLogger:
    def __init__(self, logdir: str, csv_name: str = "train_data.csv"):
        os.makedirs(logdir, exist_ok=True)
        self.csv_path = os.path.join(logdir, csv_name)
        self._fieldnames = ["step"]
        self._rows = []

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        for k in row:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        self._rows.append(row)

    def flush(self) -> None:
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, restval="")
            w.writeheader()
            w.writerows(self._rows)

    @staticmethod
    def format_console(step: int, metrics: Dict[str, float]) -> str:
        """The reference's loss line (qattention:878-889), with the renderer's
        overflow counters."""
        parts = [f"step {step}"]
        for k in ("total_loss", "bc_loss", "trans_loss", "rot_loss",
                  "grip_loss", "collision_loss", "rgb_loss", "embed_loss",
                  "dyna_loss", "psnr", "overflow_splats", "overflow_gaussians"):
            if k in metrics:
                parts.append(f"{k}: {float(metrics[k]):.4f}")
        return " | ".join(parts)
