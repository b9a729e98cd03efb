"""Training-time reconstruction panels (the counterpart of
`manigaussian_tpu/utils/visualization.py`; reference
`qattention_manigaussian_bc_agent.py:921-1010`).

Every `render_freq` steps the training runner renders the first target view
in inference mode and writes one figure, <logdir>/recon/<step>.png: input
RGB, ground-truth view, predicted view, predicted and ground-truth embedding
(each normalized to [0, 1]) and the next frame's prediction and ground
truth, whichever are given, side by side at the first image's height, each
under its title. Host-side Pillow, imported at the call.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_TITLE_H = 12


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
    from PIL import Image, ImageDraw

    panels = [("input", input_rgb), ("gt", gt_rgb), ("pred", pred_rgb),
              ("embed", pred_embed), ("gt_embed", gt_embed),
              ("next_pred", next_pred_rgb), ("next_gt", next_gt_rgb)]
    panels = [(t, p) for t, p in panels if p is not None]
    out_dir = os.path.join(logdir, "recon")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{step}.png")

    tiles = []
    for title, img in panels:
        img = np.asarray(img, np.float32)
        if img.ndim == 4:
            img = img[0]
        if title in ("embed", "gt_embed"):
            img = _norm01(img)
        tiles.append(Image.fromarray(
            (np.clip(img[..., :3], 0, 1) * 255).round().astype(np.uint8)))
    h = tiles[0].height if tiles else 1
    tiles = [t if t.height == h else t.resize((t.width * h // t.height, h))
             for t in tiles]
    fig = Image.new("RGB", (max(1, sum(t.width for t in tiles)),
                            h + _TITLE_H), "white")
    draw = ImageDraw.Draw(fig)
    x = 0
    for (title, _), t in zip(panels, tiles):
        draw.text((x + 1, 0), title, fill="black")
        fig.paste(t, (x, _TITLE_H))
        x += t.width
    fig.save(path)
    return path
