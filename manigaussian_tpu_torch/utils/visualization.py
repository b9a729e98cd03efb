"""Training-time reconstruction panels (a copy of
`manigaussian_tpu/utils/visualization.py`; reference
`qattention_manigaussian_bc_agent.py:921-1010`).

Every `render_freq` steps the training runner renders the first target view
in inference mode and writes one figure, <logdir>/recon/<step>.png: input
RGB, ground-truth view, predicted view, predicted and ground-truth embedding
(each normalized to [0, 1]) and the next frame's prediction and ground
truth, whichever are given. Host-side matplotlib, imported at the call.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _norm01(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-8:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def save_recon_panel(logdir: str, step: int,
                     input_rgb: Optional[np.ndarray] = None,
                     gt_rgb: Optional[np.ndarray] = None,
                     pred_rgb: Optional[np.ndarray] = None,
                     pred_embed: Optional[np.ndarray] = None,
                     gt_embed: Optional[np.ndarray] = None,
                     next_pred_rgb: Optional[np.ndarray] = None,
                     next_gt_rgb: Optional[np.ndarray] = None) -> str:
    """Write the panel figure of the given images; returns the file path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [("input", input_rgb), ("gt", gt_rgb), ("pred", pred_rgb),
              ("embed", pred_embed), ("gt_embed", gt_embed),
              ("next_pred", next_pred_rgb), ("next_gt", next_gt_rgb)]
    panels = [(t, p) for t, p in panels if p is not None]
    fig, axes = plt.subplots(1, max(1, len(panels)),
                             figsize=(3 * max(1, len(panels)), 3))
    if len(panels) == 1:
        axes = [axes]
    for ax, (title, img) in zip(axes, panels):
        img = np.asarray(img)
        if img.ndim == 4:
            img = img[0]
        if title in ("embed", "gt_embed"):
            img = _norm01(img)
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title)
        ax.axis("off")
    out_dir = os.path.join(logdir, "recon")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{step}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
