"""Stored-demo episode format: directory layout, writers, readers.

A copy of `manigaussian_tpu/data/episode.py` (same on-disk format), except
that Pillow is imported only where a PNG is read or written.

NATIVE layout, mirroring the reference RLBench storage structure
(`rlbench/backend/const.py:3-27`, `rlbench/utils.py:115-231`,
NeRFTaskRecorder.save `yarr/utils/video_utils.py:219-278`) with two
deliberate deviations noted inline below (plain-array npz instead of a
pickled rlbench Demo; float32 .npy depth instead of 24-bit PNG). Datasets
generated by the reference tooling therefore do NOT load directly — convert
them once with `python -m manigaussian_tpu_torch.tools.import_rlbench` (which
unpickles `low_dim_obs.pkl` through class shims and rescales PNG depth by
the stored near/far planes); `nerf_data/` is byte-identical in both layouts:

    <task>/all_variations/episodes/episode<k>/
        front_rgb/<t>.png            (uint8 RGB)
        front_depth/<t>.npy          (float32 metric depth; the reference stores
                                      8-bit PNGs — we keep full precision)
        low_dim_obs.npz              (gripper/joint/camera state per step; the
                                      reference pickles an rlbench Demo object —
                                      we store plain arrays, no class dependency)
        variation_descriptions.json  (language goals)
        nerf_data/<t>/images/<v>.png
        nerf_data/<t>/depths/<v>.png
        nerf_data/<t>/poses/<v>.txt  (4x4 extrinsic, blank line, 3x3 intrinsic —
                                      exact parse_camera_file format,
                                      qattention_manigaussian_bc_agent.py:86-113)

Camera extrinsics are cam→world (c2w), like the reference's saved poses.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

FRONT_RGB = "front_rgb"
FRONT_DEPTH = "front_depth"
LOW_DIM = "low_dim_obs.npz"
DESCRIPTIONS = "variation_descriptions.json"
NERF_FOLDER = "nerf_data"
EPISODES_FOLDER = "episodes"
VARIATIONS_ALL_FOLDER = "all_variations"


@dataclass
class EpisodeData:
    """In-memory episode: T timesteps of low-dim state + image paths."""

    gripper_open: np.ndarray            # [T]
    gripper_pose: np.ndarray            # [T, 7] xyz + quat xyzw
    gripper_joint_positions: np.ndarray  # [T, 2]
    joint_velocities: np.ndarray        # [T, J]
    ignore_collisions: np.ndarray       # [T]
    camera_extrinsics: Dict[str, np.ndarray]  # cam → [T, 4, 4] c2w
    camera_intrinsics: Dict[str, np.ndarray]  # cam → [T, 3, 3]
    descriptions: List[str]
    path: str = ""
    # lazily-resolved per-step asset paths
    rgb_paths: Dict[str, List[str]] = field(default_factory=dict)
    depth_paths: Dict[str, List[str]] = field(default_factory=dict)
    nerf_rgb_paths: List[Optional[np.ndarray]] = field(default_factory=list)
    nerf_depth_paths: List[Optional[np.ndarray]] = field(default_factory=list)
    nerf_camera_paths: List[Optional[np.ndarray]] = field(default_factory=list)

    def __len__(self):
        return int(self.gripper_open.shape[0])


def episode_dir(root: str, task: str, index: int) -> str:
    return os.path.join(root, task, VARIATIONS_ALL_FOLDER, EPISODES_FOLDER,
                        f"episode{index}")


def write_camera_txt(path: str, extrinsic_c2w: np.ndarray,
                     intrinsic: np.ndarray) -> None:
    """Exact format of NeRFTaskRecorder camera files (parse_camera_file parity)."""
    lines = []
    for row in np.asarray(extrinsic_c2w).reshape(4, 4):
        lines.append(" ".join(f"{v:.18e}" for v in row))
    lines.append("")
    for row in np.asarray(intrinsic).reshape(3, 3):
        lines.append(" ".join(f"{v:.18e}" for v in row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def parse_camera_txt(path: str):
    """4x4 extrinsic + blank + 3x3 intrinsic (qattention:86-113)."""
    with open(path) as f:
        lines = f.readlines()
    extr = np.array([float(v) for x in lines[0:4] for v in x.split()]).reshape(4, 4)
    intr = np.array([float(v) for x in lines[5:8] for v in x.split()]).reshape(3, 3)
    return extr.astype(np.float32), intr.astype(np.float32), float(intr[0, 0])


def load_image(path: str) -> np.ndarray:
    """RGB png → float32 [0,1] (parse_img_file parity, qattention:115-121)."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB")).astype(np.float32) / 255.0


def load_depth(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    # reference depth: 8-bit grayscale PNG (parse_depth_file, qattention:123-129)
    from PIL import Image
    return np.asarray(Image.open(path).convert("L")).astype(np.float32)


def write_episode(root: str, task: str, index: int,
                  rgb: Dict[str, np.ndarray],          # cam → [T, H, W, 3] uint8
                  depth: Dict[str, np.ndarray],        # cam → [T, H, W] float32
                  low_dim: Dict[str, np.ndarray],
                  camera_extrinsics: Dict[str, np.ndarray],
                  camera_intrinsics: Dict[str, np.ndarray],
                  descriptions: List[str],
                  nerf_views: Optional[dict] = None) -> str:
    """Persist one episode. nerf_views: {t: (rgbs [V,H,W,3]u8, depths [V,H,W]f32,
    extrinsics [V,4,4], intrinsics [V,3,3])}."""
    from PIL import Image

    ep = episode_dir(root, task, index)
    os.makedirs(ep, exist_ok=True)
    t_steps = next(iter(rgb.values())).shape[0]

    for cam, frames in rgb.items():
        d = os.path.join(ep, f"{cam}_rgb")
        os.makedirs(d, exist_ok=True)
        for t in range(t_steps):
            Image.fromarray(frames[t]).save(os.path.join(d, f"{t}.png"))
    for cam, frames in depth.items():
        d = os.path.join(ep, f"{cam}_depth")
        os.makedirs(d, exist_ok=True)
        for t in range(t_steps):
            np.save(os.path.join(d, f"{t}.npy"), frames[t].astype(np.float32))

    arrays = dict(low_dim)
    for cam, e in camera_extrinsics.items():
        arrays[f"{cam}_camera_extrinsics"] = e
    for cam, i in camera_intrinsics.items():
        arrays[f"{cam}_camera_intrinsics"] = i
    np.savez_compressed(os.path.join(ep, LOW_DIM), **arrays)

    with open(os.path.join(ep, DESCRIPTIONS), "w") as f:
        json.dump(descriptions, f)

    if nerf_views:
        for t, (rgbs, depths, extrs, intrs) in nerf_views.items():
            base = os.path.join(ep, NERF_FOLDER, str(t))
            for sub in ("images", "depths", "poses"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            for v in range(rgbs.shape[0]):
                Image.fromarray(rgbs[v]).save(
                    os.path.join(base, "images", f"{v}.png"))
                d8 = np.clip(depths[v], 0, 255).astype(np.uint8)
                Image.fromarray(d8, mode="L").save(
                    os.path.join(base, "depths", f"{v}.png"))
                write_camera_txt(os.path.join(base, "poses", f"{v}.txt"),
                                 extrs[v], intrs[v])
    return ep


def _natsorted(names):
    def key(n):
        stem = os.path.splitext(n)[0]
        return (0, int(stem)) if stem.isdigit() else (1, stem)
    return sorted(names, key=key)


def load_episode(ep_path: str, cameras=("front",)) -> EpisodeData:
    """Read one stored episode (path-based images, parity with
    rlbench/utils.py:142-231: images stay on disk until sampled)."""
    z = np.load(os.path.join(ep_path, LOW_DIM), allow_pickle=False)
    with open(os.path.join(ep_path, DESCRIPTIONS)) as f:
        descriptions = json.load(f)

    t_steps = z["gripper_open"].shape[0]
    data = EpisodeData(
        gripper_open=z["gripper_open"],
        gripper_pose=z["gripper_pose"],
        gripper_joint_positions=z["gripper_joint_positions"],
        joint_velocities=z["joint_velocities"],
        ignore_collisions=z["ignore_collisions"],
        camera_extrinsics={c: z[f"{c}_camera_extrinsics"] for c in cameras},
        camera_intrinsics={c: z[f"{c}_camera_intrinsics"] for c in cameras},
        descriptions=descriptions,
        path=ep_path,
    )
    for cam in cameras:
        data.rgb_paths[cam] = [
            os.path.join(ep_path, f"{cam}_rgb", f"{t}.png")
            for t in range(t_steps)]
        data.depth_paths[cam] = [
            os.path.join(ep_path, f"{cam}_depth", f"{t}.npy")
            for t in range(t_steps)]

    nerf_root = os.path.join(ep_path, NERF_FOLDER)
    for t in range(t_steps):
        base = os.path.join(nerf_root, str(t))
        img_dir = os.path.join(base, "images")
        if not os.path.isdir(img_dir):
            data.nerf_rgb_paths.append(None)
            data.nerf_depth_paths.append(None)
            data.nerf_camera_paths.append(None)
            continue
        imgs = _natsorted(os.listdir(img_dir))
        data.nerf_rgb_paths.append(
            np.array([os.path.join(img_dir, f) for f in imgs]))
        data.nerf_depth_paths.append(np.array(
            [os.path.join(base, "depths", f)
             for f in _natsorted(os.listdir(os.path.join(base, "depths")))]))
        data.nerf_camera_paths.append(np.array(
            [os.path.join(base, "poses", f)
             for f in _natsorted(os.listdir(os.path.join(base, "poses")))]))
    return data


def list_episodes(root: str, task: str) -> List[str]:
    d = os.path.join(root, task, VARIATIONS_ALL_FOLDER, EPISODES_FOLDER)
    if not os.path.isdir(d):
        return []
    eps = [e for e in os.listdir(d) if e.startswith("episode")]
    return [os.path.join(d, e) for e in sorted(eps, key=lambda s: int(s[7:]))]
