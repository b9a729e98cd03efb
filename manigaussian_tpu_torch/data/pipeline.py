"""Host data pipeline: stored demos → keyframe transitions → batches (port of
`manigaussian_tpu/data/pipeline.py`; reference `launch_utils.py:191-330`,
`qattention_manigaussian_bc_agent.py:680-739`).

`fill_replay` adds one transition per keyframe (start-point demo
augmentation every N steps), `assemble_batch` loads the images, unprojects
depth with the port's own `ops/camera.depth_to_pointcloud` and picks a
random nerf view, and `BatchIterator` assembles batches in a background
prefetch thread. The euler discretization of the actions is numpy in
float64 (the JAX package calls scipy's `as_euler('xyz')`, whose angles for a
rotation matrix are these closed forms).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from manigaussian_tpu_torch.data import episode as ep
from manigaussian_tpu_torch.data.keypoints import keypoint_discovery
from manigaussian_tpu_torch.data.language import LanguageModel
from manigaussian_tpu_torch.data.replay import (TaskUniformReplay, Transition,
                                                stack_transitions)
from manigaussian_tpu_torch.ops.camera import depth_to_pointcloud

REWARD_SCALE = 100.0


def point_to_voxel_index_np(point, voxel_size, bounds):
    """helpers/utils.py:81-93 (top-clamped floor index)."""
    bb_mins = np.array(bounds[0:3])
    bb_maxs = np.array(bounds[3:])
    res = (bb_maxs - bb_mins) / (np.array([voxel_size] * 3) + 1e-12)
    return np.minimum(np.floor((point - bb_mins) / (res + 1e-12)).astype(np.int32),
                      voxel_size - 1)


def quaternion_to_discrete_euler_np(quat_xyzw, resolution):
    """helpers/utils.py:68-73: extrinsic 'xyz' euler degrees + 180, rounded
    at `resolution`, 360 wraps to 0."""
    x, y, z, w = np.asarray(quat_xyzw, np.float64) / np.linalg.norm(quat_xyzw)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    r10 = 2 * (x * y + w * z)
    r00 = 1 - 2 * (y * y + z * z)
    euler = np.degrees([np.arctan2(r21, r22), np.arcsin(np.clip(-r20, -1, 1)),
                        np.arctan2(r10, r00)]) + 180
    disc = np.around(euler / resolution).astype(np.int32)
    disc[disc == int(360 / resolution)] = 0
    return disc


def get_action(demo: ep.EpisodeData, keypoint: int, scene_bounds,
               voxel_size: int, rotation_resolution: int):
    """launch_utils._get_action (:148-188) on array episodes."""
    pose = demo.gripper_pose[keypoint]
    quat = pose[3:7] / np.linalg.norm(pose[3:7])
    if quat[-1] < 0:
        quat = -quat
    disc_rot = quaternion_to_discrete_euler_np(quat, rotation_resolution)
    trans_idx = point_to_voxel_index_np(pose[:3], voxel_size, scene_bounds)
    grip = float(demo.gripper_open[keypoint])
    ignore_collisions = int(demo.ignore_collisions[max(0, keypoint - 1)])
    action = np.concatenate([pose, [grip]]).astype(np.float32)
    rot_grip = np.concatenate([disc_rot, [int(grip)]]).astype(np.int32)
    return (trans_idx.astype(np.int32), rot_grip,
            np.array([ignore_collisions], np.int32), action)


def make_transition(demo: ep.EpisodeData, t: int, keypoint: int, k_index: int,
                    cameras: Sequence[str], scene_bounds, voxel_size: int,
                    rotation_resolution: int, episode_length: int,
                    description: str, lang: LanguageModel,
                    next_t: Optional[int], task: str,
                    terminal: bool) -> Transition:
    trans_idx, rot_grip, ignore_coll, action = get_action(
        demo, keypoint, scene_bounds, voxel_size, rotation_resolution)
    sent, toks = lang.encode(description)
    time_v = (1.0 - (k_index / float(episode_length - 1))) * 2.0 - 1.0
    low_dim = np.array([demo.gripper_open[t],
                        *np.clip(demo.gripper_joint_positions[t], 0.0, 0.04),
                        time_v], np.float32)
    nt = next_t if next_t is not None else t
    return {
        "task": task,
        "lang_goal": description,
        "low_dim_state": low_dim,
        "trans_action_indicies": trans_idx,
        "rot_grip_action_indicies": rot_grip,
        "ignore_collisions": ignore_coll,
        "gripper_pose": demo.gripper_pose[keypoint].astype(np.float32),
        "action": action,
        "reward": np.float32(REWARD_SCALE if terminal else 0.0),
        "terminal": np.bool_(terminal),
        "lang_goal_emb": sent,
        "lang_token_embs": toks,
        "rgb_paths": np.array([demo.rgb_paths[c][t] for c in cameras], dtype=object),
        "depth_paths": np.array([demo.depth_paths[c][t] for c in cameras],
                                dtype=object),
        "camera_extrinsics": np.stack(
            [demo.camera_extrinsics[c][t] for c in cameras]).astype(np.float32),
        "camera_intrinsics": np.stack(
            [demo.camera_intrinsics[c][t] for c in cameras]).astype(np.float32),
        "nerf_multi_view_rgb": demo.nerf_rgb_paths[t],
        "nerf_multi_view_depth": demo.nerf_depth_paths[t],
        "nerf_multi_view_camera": demo.nerf_camera_paths[t],
        "nerf_next_multi_view_rgb": demo.nerf_rgb_paths[nt],
        "nerf_next_multi_view_depth": demo.nerf_depth_paths[nt],
        "nerf_next_multi_view_camera": demo.nerf_camera_paths[nt],
    }


def fill_replay(replay: TaskUniformReplay, root: str, task: str,
                num_demos: int, cameras: Sequence[str], scene_bounds,
                voxel_size: int, rotation_resolution: int,
                episode_length: int, lang: LanguageModel,
                demo_augmentation: bool = True,
                demo_augmentation_every_n: int = 10,
                keypoint_method: str = "heuristic") -> int:
    """fill_replay (launch_utils.py:270-330). Returns #transitions."""
    count = 0
    for ep_path in ep.list_episodes(root, task)[:num_demos]:
        demo = ep.load_episode(ep_path, cameras)
        keypoints_all = keypoint_discovery(
            demo.gripper_open, demo.joint_velocities, method=keypoint_method)
        desc = demo.descriptions[0]
        for i in range(len(demo) - 1):
            if not demo_augmentation and i > 0:
                break
            if i % demo_augmentation_every_n != 0:
                continue
            keypoints = [k for k in keypoints_all if i < k]
            if not keypoints:
                break
            t = i
            for k_idx, kp in enumerate(keypoints):
                terminal = k_idx == len(keypoints) - 1
                next_t = kp if not terminal else max(0, kp - 1)
                replay.add(task, make_transition(
                    demo, t, kp, k_idx, cameras, scene_bounds, voxel_size,
                    rotation_resolution, episode_length, desc, lang,
                    next_t, task, terminal))
                count += 1
                t = kp
    return count


def _select_view(paths_rgb, paths_depth, paths_cam, num_view_by_user: int,
                 rng: np.random.Generator):
    """Random target view with interval subsampling (qattention:694-713)."""
    num_view = len(paths_rgb)
    interval = max(1, num_view // min(num_view_by_user, num_view))
    sub = list(range(0, num_view, interval))[:num_view_by_user]
    vi = sub[rng.integers(len(sub))]
    return paths_rgb[vi], paths_depth[vi], paths_cam[vi]


def assemble_batch(transitions: List[Transition], rng: np.random.Generator,
                   num_view_for_nerf: int = 20,
                   load_nerf_targets: bool = True) -> Dict[str, np.ndarray]:
    """Transitions → numpy batch of the agent.update schema."""
    stacked = stack_transitions(transitions)
    rgbs, pcds = [], []
    for tr in transitions:
        cam_rgb, cam_pcd = [], []
        for ci in range(len(tr["rgb_paths"])):
            depth = ep.load_depth(tr["depth_paths"][ci])
            w2c = np.linalg.inv(tr["camera_extrinsics"][ci])
            pcd = depth_to_pointcloud(
                torch.from_numpy(np.asarray(depth, np.float32)),
                torch.from_numpy(w2c.astype(np.float32)),
                torch.from_numpy(np.asarray(tr["camera_intrinsics"][ci], np.float32)))
            cam_rgb.append(ep.load_image(tr["rgb_paths"][ci]))
            cam_pcd.append(pcd.numpy().reshape(depth.shape[0], depth.shape[1], 3))
        rgbs.append(np.stack(cam_rgb))
        pcds.append(np.stack(cam_pcd))
    batch: Dict[str, np.ndarray] = {
        "rgb": np.stack(rgbs).astype(np.float32),
        "pcd": np.stack(pcds).astype(np.float32),
    }
    for k in ("low_dim_state", "lang_goal_emb", "lang_token_embs",
              "trans_action_indicies", "rot_grip_action_indicies",
              "ignore_collisions", "gripper_pose", "action",
              "camera_extrinsics"):
        batch[k] = stacked[k]
    if load_nerf_targets and transitions[0]["nerf_multi_view_rgb"] is not None:
        views = {k: [] for k in ("rgb", "pose", "intr", "nrgb", "npose", "nintr")}
        for tr in transitions:
            r, _d, c = _select_view(tr["nerf_multi_view_rgb"],
                                    tr["nerf_multi_view_depth"],
                                    tr["nerf_multi_view_camera"],
                                    num_view_for_nerf, rng)
            extr, intr, _f = ep.parse_camera_txt(c)
            views["rgb"].append(ep.load_image(r))
            views["pose"].append(extr)
            views["intr"].append(intr)
            r2, _d2, c2 = _select_view(tr["nerf_next_multi_view_rgb"],
                                       tr["nerf_next_multi_view_depth"],
                                       tr["nerf_next_multi_view_camera"],
                                       num_view_for_nerf, rng)
            extr2, intr2, _ = ep.parse_camera_txt(c2)
            views["nrgb"].append(ep.load_image(r2))
            views["npose"].append(extr2)
            views["nintr"].append(intr2)
        batch.update(
            nerf_target_rgb=np.stack(views["rgb"]),
            nerf_target_pose=np.stack(views["pose"]),
            nerf_target_intrinsic=np.stack(views["intr"]),
            nerf_next_target_rgb=np.stack(views["nrgb"]),
            nerf_next_target_pose=np.stack(views["npose"]),
            nerf_next_target_intrinsic=np.stack(views["nintr"]))
    return batch


class BatchIterator:
    """Replay → assembled batches with a background prefetch thread. A full
    queue retries the same batch, so the sampling sequence does not depend
    on timing."""

    def __init__(self, replay: TaskUniformReplay, batch_size: int,
                 seed: int = 0, num_view_for_nerf: int = 20,
                 load_nerf_targets: bool = True, prefetch: int = 2):
        self.replay = replay
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.num_view_for_nerf = num_view_for_nerf
        self.load_nerf_targets = load_nerf_targets
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = assemble_batch(self.replay.sample(self.batch_size, self.rng),
                                      self.rng, self.num_view_for_nerf,
                                      self.load_nerf_targets)
            except Exception as e:  # surface loader errors to the consumer
                self._q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
