"""The traffic generator of the training and act cells: synthetic
ManiGaussian demonstrations from a seed, a frozen copy of the port's
`data/synthetic.py` and of its episode writer (`data/episode.py`).

Every image (front camera and NeRF views) is ray-cast from one scene: a
checkered table plane, an "object" sphere at the next keyframe's gripper
position whose colour encodes that keyframe's gripper bit, a "gripper"
sphere moving along the trajectory, and distractor spheres. The episodes
are written in the port's on-disk layout (`<task>/all_variations/episodes/
episode<k>/...`) and returned in memory for the reference. A mix's
parameters (`benchmark/traffic/<mix>.json`) are the arguments of
`make_episodes`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..reference.keypoints import keypoint_discovery

FRONT_RGB = "front_rgb"
FRONT_DEPTH = "front_depth"
LOW_DIM = "low_dim_obs.npz"
DESCRIPTIONS = "variation_descriptions.json"
NERF_FOLDER = "nerf_data"
EPISODES_FOLDER = "episodes"
VARIATIONS_ALL_FOLDER = "all_variations"

SCENE_BOUNDS = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)

# distractor palette — intentionally excludes white/red (the grip-bit colors)
DISTRACTOR_COLORS = np.array([
    [60, 220, 80],    # green
    [255, 160, 40],   # orange
    [60, 210, 220],   # cyan
    [220, 60, 220],   # magenta
], np.float32)

_GRIPPER_COLOR = np.array([70, 110, 255], np.float32)   # blue
_OPEN_COLOR = np.array([255, 255, 255], np.float32)     # white = open
_CLOSE_COLOR = np.array([255, 40, 40], np.float32)      # red = close
_BG_COLOR = np.array([15, 15, 20], np.float32)
_BG_DEPTH = 3.5            # inside znear/zfar (0.1/4.0), outside scene bounds
_PLANE_Z = 0.75
_LIGHT = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])

# per-camera eye offsets from the scene center (RLBench's five-camera rig,
# rlbench/observation_config.py:59-77; poses chosen to keep _look_at
# non-degenerate). Unknown camera names fall back to the front viewpoint.
_CAMERA_EYES = {
    "front": (0.0, -0.8, 0.5),
    "overhead": (0.25, 0.05, 0.95),
    "left_shoulder": (-0.55, 0.5, 0.45),
    "right_shoulder": (-0.55, -0.5, 0.45),
    "wrist": (0.4, 0.1, 0.3),
}


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """c2w pose with +z forward (OpenCV convention, matches RLBench cameras)."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w.astype(np.float32)


def _intrinsics(h, w, focal):
    return np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]],
                    np.float32)


def render_scene(c2w, intr, h, w, spheres, plane_z=_PLANE_Z, rng=None,
                 noise=2.0):
    """Ray-cast one view of a sphere/plane scene.

    Pixel centers at +0.5 and z-depth convention exactly match
    ops/camera.depth_to_pointcloud (graphics_utils.py:56-78 parity), so
    unprojecting the returned depth reconstructs the scene geometry bit-true.

    spheres: sequence of (center [3], radius, color [3] in 0..255).
    Returns (rgb uint8 [h,w,3], depth float32 [h,w] z-depth).
    """
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    yy, xx = np.meshgrid(np.linspace(0.5, h - 0.5, h),
                         np.linspace(0.5, w - 0.5, w), indexing="ij")
    # camera-frame ray directions with unit z: depth along the ray IS z-depth
    v = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                 -1).reshape(-1, 3)
    eye = c2w[:3, 3].astype(np.float64)
    d = v @ c2w[:3, :3].T.astype(np.float64)                  # world dirs [P,3]

    depth = np.full(h * w, np.inf)
    color = np.tile(_BG_COLOR, (h * w, 1))

    # table plane z = plane_z (checkerboard in world x/y)
    denom = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (plane_z - eye[2]) / denom
    p = eye + s[:, None] * d
    # clamp the table to the workspace footprint — grazing rays otherwise hit
    # the plane at horizon distances far outside the scene bounds
    hit = ((np.abs(denom) > 1e-9) & (s > 0.05) & (s < depth)
           & (np.abs(p[:, 0] - 0.2) <= 0.55) & (np.abs(p[:, 1]) <= 0.55))
    if hit.any():
        checker = ((np.floor(p[hit, 0] / 0.1) + np.floor(p[hit, 1] / 0.1))
                   % 2).astype(bool)
        depth[hit] = s[hit]
        color[hit] = np.where(checker[:, None], 95.0, 140.0) * np.ones((1, 3))

    for center, radius, col in spheres:
        center = np.asarray(center, np.float64)
        oc = eye - center
        A = np.sum(d * d, -1)
        B = 2.0 * d @ oc
        C = oc @ oc - radius * radius
        disc = B * B - 4 * A * C
        ok = disc > 0
        s = np.full(h * w, np.inf)
        s[ok] = (-B[ok] - np.sqrt(disc[ok])) / (2 * A[ok])
        hit = ok & (s > 0.05) & (s < depth)
        if hit.any():
            p = eye + s[hit, None] * d[hit]
            n = (p - center) / radius
            shade = 0.55 + 0.45 * np.clip(n @ _LIGHT, 0.0, 1.0)
            depth[hit] = s[hit]
            color[hit] = np.asarray(col, np.float32) * shade[:, None]

    depth[~np.isfinite(depth)] = _BG_DEPTH
    if rng is not None and noise > 0:
        color = color + rng.normal(0.0, noise, color.shape)
    rgb = np.clip(color, 0, 255).astype(np.uint8).reshape(h, w, 3)
    return rgb, depth.astype(np.float32).reshape(h, w)


def _scene_spheres(pos, gripper_open, kps, t, distractors):
    """Scene state at timestep t: object sphere at the NEXT keyframe target
    (color = that keyframe's grip bit), gripper sphere at the current gripper
    position, plus the episode's fixed distractors."""
    nxt = [k for k in kps if k > t]
    kp = nxt[0] if nxt else (kps[-1] if kps else len(pos) - 1)
    obj_color = _OPEN_COLOR if gripper_open[kp] > 0.5 else _CLOSE_COLOR
    spheres = [(pos[kp], 0.05, obj_color), (pos[t], 0.035, _GRIPPER_COLOR)]
    spheres.extend(distractors)
    return spheres


def _make_distractors(rng, keyframe_positions, n):
    """Fixed per-episode distractor spheres, rejected away from every keyframe
    target so they can't be mistaken for the object."""
    out = []
    lo = np.array([-0.15, -0.35, 0.85])
    hi = np.array([0.55, 0.35, 1.35])
    tries = 0
    while len(out) < n and tries < 200:
        tries += 1
        c = rng.uniform(lo, hi)
        if keyframe_positions.size and (
                np.linalg.norm(keyframe_positions - c, axis=-1).min() < 0.12):
            continue
        col = DISTRACTOR_COLORS[rng.integers(len(DISTRACTOR_COLORS))]
        out.append((c.astype(np.float32), float(rng.uniform(0.03, 0.05)), col))
    return out


def make_episodes(seed: int, task: str, episodes: int = 2,
                  timesteps: int = 16, image_size: int = 128,
                  nerf_views: int = 21, nerf_size: int = 128,
                  num_distractors: int = 3, noise: float = 2.0,
                  root: Optional[str] = None) -> List[Dict]:
    """`episodes` demonstrations of `timesteps` steps from `seed`: the
    front camera at image_size², `nerf_views` ring views at nerf_size² for
    every step but the last. Written under `root` when given."""
    rng = np.random.default_rng(seed)
    center = np.array([0.2, 0.0, 1.1], np.float32)
    h = w = image_size
    out = []
    for e in range(episodes):
        # gripper trajectory: start → grasp (close) → lift (open at end)
        t_axis = np.linspace(0, 1, timesteps)
        pos = center + np.stack([
            0.2 * np.cos(2 * np.pi * t_axis * 0.25 + e),
            0.2 * np.sin(2 * np.pi * t_axis * 0.25 + e),
            0.1 * t_axis], -1).astype(np.float32)
        quat = np.tile(np.array([0, 0, 0, 1.0], np.float32), (timesteps, 1))
        gripper_pose = np.concatenate([pos, quat], -1)
        gripper_open = np.ones(timesteps, np.float32)
        gripper_open[timesteps // 3: 2 * timesteps // 3] = 0.0
        joint_vel = rng.normal(0, 1.0, (timesteps, 7)).astype(np.float32)
        joint_vel[timesteps // 2] = 0.0  # one stopped keyframe
        grip_joints = np.tile(np.array([0.02, 0.02], np.float32), (timesteps, 1))
        ignore_coll = np.zeros(timesteps, np.float32)

        kps = keypoint_discovery(gripper_open, joint_vel)
        distractors = _make_distractors(
            rng, pos[np.asarray(kps, int)] if kps else pos[:0],
            num_distractors)

        intr = _intrinsics(h, w, focal=float(w))
        cam_pose = _look_at(center + np.array(_CAMERA_EYES["front"]), center)
        front_rgb = np.empty((timesteps, h, w, 3), np.uint8)
        front_depth = np.empty((timesteps, h, w), np.float32)
        for t in range(timesteps):
            spheres = _scene_spheres(pos, gripper_open, kps, t, distractors)
            front_rgb[t], front_depth[t] = render_scene(
                cam_pose, intr, h, w, spheres, rng=rng, noise=noise)

        # nerf views: ring cameras rendering the scene state of frame t
        ring = []
        for vi in range(nerf_views):
            ang = 2 * np.pi * vi / nerf_views
            eye = center + np.array([0.8 * np.cos(ang), 0.8 * np.sin(ang),
                                     0.5 + 0.12 * ((vi % 3) - 1)])
            ring.append(_look_at(eye, center))
        nerf_intr = _intrinsics(nerf_size, nerf_size, float(nerf_size))
        nerf_rgb = np.zeros((timesteps, nerf_views, nerf_size, nerf_size, 3),
                            np.uint8)
        nerf_depth = np.zeros((timesteps, nerf_views, nerf_size, nerf_size),
                              np.float32)
        for t in range(timesteps - 1):  # the last step has no nerf data
            spheres = _scene_spheres(pos, gripper_open, kps, t, distractors)
            for vi in range(nerf_views):
                nerf_rgb[t, vi], nerf_depth[t, vi] = render_scene(
                    ring[vi], nerf_intr, nerf_size, nerf_size, spheres,
                    rng=rng, noise=noise)
        ep = dict(gripper_open=gripper_open, gripper_pose=gripper_pose,
                  gripper_joint_positions=grip_joints,
                  joint_velocities=joint_vel, ignore_collisions=ignore_coll,
                  front_rgb=front_rgb, front_depth=front_depth,
                  front_extrinsic=cam_pose, front_intrinsic=intr,
                  nerf_rgb=nerf_rgb, nerf_pose=np.stack(ring) if ring else None,
                  nerf_intrinsic=nerf_intr,
                  description=f"{task.replace('_', ' ')} demo")
        if root is not None:
            write_episode(root, task, e, ep, nerf_depth)
        out.append(ep)
    return out


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


def write_episode(root: str, task: str, index: int, ep: Dict,
                  nerf_depth: np.ndarray) -> str:
    """One episode in the port's layout (PNG at compression level 1: the
    pixels are the same at any level)."""
    from PIL import Image

    d = episode_dir(root, task, index)
    steps = ep["front_rgb"].shape[0]
    os.makedirs(os.path.join(d, FRONT_RGB), exist_ok=True)
    os.makedirs(os.path.join(d, FRONT_DEPTH), exist_ok=True)
    for t in range(steps):
        Image.fromarray(ep["front_rgb"][t]).save(
            os.path.join(d, FRONT_RGB, f"{t}.png"), compress_level=1)
        np.save(os.path.join(d, FRONT_DEPTH, f"{t}.npy"), ep["front_depth"][t])
    arrays = {k: ep[k] for k in ("gripper_open", "gripper_pose",
                                 "gripper_joint_positions", "joint_velocities",
                                 "ignore_collisions")}
    arrays["front_camera_extrinsics"] = np.tile(ep["front_extrinsic"],
                                                (steps, 1, 1))
    arrays["front_camera_intrinsics"] = np.tile(ep["front_intrinsic"],
                                                (steps, 1, 1))
    np.savez_compressed(os.path.join(d, LOW_DIM), **arrays)
    with open(os.path.join(d, DESCRIPTIONS), "w") as f:
        json.dump([ep["description"]], f)
    views = ep["nerf_rgb"].shape[1]
    for t in range(steps - 1 if views else 0):
        base = os.path.join(d, NERF_FOLDER, str(t))
        for sub in ("images", "depths", "poses"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for v in range(views):
            Image.fromarray(ep["nerf_rgb"][t, v]).save(
                os.path.join(base, "images", f"{v}.png"), compress_level=1)
            d8 = np.clip(nerf_depth[t, v], 0, 255).astype(np.uint8)
            Image.fromarray(d8, mode="L").save(
                os.path.join(base, "depths", f"{v}.png"), compress_level=1)
            write_camera_txt(os.path.join(base, "poses", f"{v}.txt"),
                             ep["nerf_pose"][v], ep["nerf_intrinsic"])
    return d
