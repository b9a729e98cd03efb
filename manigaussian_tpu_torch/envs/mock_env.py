"""Mock environment: replays stored episodes for simulator-free eval (CI).

A copy of `manigaussian_tpu/envs/mock_env.py` whose depth unprojection is
the port's `ops/camera.depth_to_pointcloud`, run on the CPU (host side).

Stands in for RLBench/CoppeliaSim (SURVEY.md §7 stage 8: 'CI uses
recorded-rollout mocks'). Semantics:
  * reset_to_demo(i) loads episode i of the current task and returns its first
    observation (RGB/pcd from disk, proprio assembled like extract_obs),
  * step(action) scores the action against the episode's NEXT ground-truth
    keyframe: success if the predicted position is within `pos_tol` meters and
    the gripper state matches; the episode advances keyframe by keyframe,
  * reward REWARD_SCALE on reaching the final keyframe successfully — matching
    the reference's sparse terminal reward.

This turns eval into 'offline action accuracy vs held-out keyframes', the
simulator-free acceptance check of SURVEY.md §7's minimum slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import torch

from manigaussian_tpu_torch.data import episode as ep
from manigaussian_tpu_torch.data.keypoints import keypoint_discovery
from manigaussian_tpu_torch.envs.base import EnvObservation, EnvStepResult
from manigaussian_tpu_torch.ops.camera import depth_to_pointcloud

REWARD_SCALE = 100.0


class MockEnvClient:
    def __init__(self, dataset_root: str, cameras=("front",),
                 episode_length: int = 25, pos_tol: float = 0.1):
        self.root = dataset_root
        self.cameras = list(cameras)
        self.episode_length = episode_length
        self.pos_tol = pos_tol
        self.task: Optional[str] = None
        self._demo: Optional[ep.EpisodeData] = None
        self._keypoints: List[int] = []
        self._k = 0
        self._t = 0

    def launch(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def set_task(self, task_name: str) -> None:
        self.task = task_name

    def _obs_at(self, t: int, k_index: int) -> EnvObservation:
        d = self._demo
        rgbs, pcds = [], []
        for c in self.cameras:
            rgb = ep.load_image(d.rgb_paths[c][t])
            depth = ep.load_depth(d.depth_paths[c][t])
            extr = d.camera_extrinsics[c][t]
            intr = d.camera_intrinsics[c][t]
            pcd = depth_to_pointcloud(
                torch.from_numpy(depth),
                torch.from_numpy(np.linalg.inv(extr).astype(np.float32)),
                torch.from_numpy(np.asarray(intr, np.float32))
            ).numpy().reshape(*depth.shape, 3)
            rgbs.append(rgb)
            pcds.append(pcd)
        time_v = (1.0 - (k_index / float(self.episode_length - 1))) * 2.0 - 1.0
        low_dim = np.array([
            d.gripper_open[t],
            *np.clip(d.gripper_joint_positions[t], 0.0, 0.04),
            time_v], np.float32)
        return EnvObservation(
            rgb=np.stack(rgbs).astype(np.float32),
            pcd=np.stack(pcds).astype(np.float32),
            low_dim_state=low_dim,
            lang_goal=d.descriptions[0])

    def reset_to_demo(self, episode_index: int) -> EnvObservation:
        assert self.task is not None, "call set_task first"
        paths = ep.list_episodes(self.root, self.task)
        assert paths, (f"no stored episodes for task {self.task!r} under "
                       f"{self.root} — generate demos for every task in "
                       f"cfg.rlbench.tasks")
        # wrap: eval protocols ask for 25 episodes (conf/eval.yaml) while CI
        # fixtures store fewer — recycle stored demos (mock-only convenience;
        # the real env has one scene seed per requested episode)
        self._demo = ep.load_episode(paths[episode_index % len(paths)],
                                     self.cameras)
        self._keypoints = keypoint_discovery(
            self._demo.gripper_open, self._demo.joint_velocities)
        self._k = 0
        self._t = 0
        return self._obs_at(0, 0)

    def step(self, action: np.ndarray) -> EnvStepResult:
        d = self._demo
        kp = self._keypoints[self._k]
        gt_pos = d.gripper_pose[kp][:3]
        gt_grip = float(d.gripper_open[kp])
        pos_ok = np.linalg.norm(action[:3] - gt_pos) <= self.pos_tol
        grip_ok = float(action[7] >= 0.5) == gt_grip
        success = bool(pos_ok and grip_ok)

        if not success:
            # failed to reach the keyframe → terminal, zero reward
            return EnvStepResult(self._obs_at(self._t, self._k), 0.0, True,
                                 info={"error_type": "missed_keyframe",
                                       "expected": gt_pos,
                                       "predicted": np.asarray(action[:3])})

        self._t = kp
        self._k += 1
        if self._k >= len(self._keypoints):
            return EnvStepResult(self._obs_at(self._t, self._k - 1),
                                 REWARD_SCALE, True, info={"success": True})
        return EnvStepResult(self._obs_at(self._t, self._k), 0.0, False, {})
