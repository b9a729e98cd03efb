"""Rollout video recording (a copy of `manigaussian_tpu/utils/video.py`;
YARR `yarr/utils/video_utils.py`).

`EpisodeRecorder` collects an episode's frames and writes them as one
animated GIF (and optionally a PNG sequence); the eval runner's
`--record-every-n` uses it. The frame conversion, the GIF's frame duration
and its loop flag are the JAX package's, so the same frames give the same
file bytes in both packages. Pillow is imported at the call.
`circular_camera_path` is the circular multi-view path of the nerf-data
generator (CircleCameraMotion).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class EpisodeRecorder:
    def __init__(self, fps: int = 30):
        self.fps = fps
        self._frames: List[np.ndarray] = []

    def add_frame(self, rgb01: np.ndarray) -> None:
        """rgb01: [H, W, 3] float in [0,1] or uint8."""
        if rgb01.dtype != np.uint8:
            rgb01 = (np.clip(rgb01, 0, 1) * 255).astype(np.uint8)
        self._frames.append(rgb01)

    def save(self, path_base: str, gif: bool = True,
             frames_dir: bool = False) -> Optional[str]:
        """Write <path_base>.gif (and optionally <path_base>/<i>.png)."""
        if not self._frames:
            return None
        from PIL import Image

        os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
        out = None
        if gif:
            imgs = [Image.fromarray(f) for f in self._frames]
            out = path_base + ".gif"
            imgs[0].save(out, save_all=True, append_images=imgs[1:],
                         duration=max(1, int(1000 / self.fps)), loop=0)
        if frames_dir:
            os.makedirs(path_base, exist_ok=True)
            for i, f in enumerate(self._frames):
                Image.fromarray(f).save(os.path.join(path_base, f"{i}.png"))
        self._frames.clear()
        return out


def circular_camera_path(center: np.ndarray, radius: float, height: float,
                         n_views: int, start_angle: float = 0.0) -> np.ndarray:
    """[V, 4, 4] c2w poses on a circle looking at `center`
    (CircleCameraMotion, video_utils.py:24-46)."""
    from manigaussian_tpu_torch.data.synthetic import _look_at

    poses = []
    for v in range(n_views):
        ang = start_angle + 2 * np.pi * v / n_views
        eye = np.asarray(center) + np.array(
            [radius * np.cos(ang), radius * np.sin(ang), height])
        poses.append(_look_at(eye, center))
    return np.stack(poses)
