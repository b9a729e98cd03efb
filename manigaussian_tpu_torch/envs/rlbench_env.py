"""RLBench/CoppeliaSim environment client (optional, gated on install; a
copy of `manigaussian_tpu/envs/rlbench_env.py`).

Parity target: `helpers/custom_rlbench_env.py:279-392`
(CustomMultiTaskRLBenchEnv): EndEffectorPoseViaPlanning action mode, stored-demo
resets, and error-tolerant stepping — IKError / ConfigurationPathError /
InvalidActionError terminate the episode with zero reward, counted per type
(:333-344).

CoppeliaSim is an x86 CPU process; this client is meant to run in a host
process (or behind an RPC bridge) next to the GPU trainer. Importing this
module without rlbench installed raises a clear error at construction, not
import time.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from manigaussian_tpu_torch.envs.base import EnvObservation, EnvStepResult

REWARD_SCALE = 100.0


class RLBenchEnvClient:
    def __init__(self, dataset_root: str, cameras=("front",),
                 image_size=(128, 128), episode_length: int = 25,
                 headless: bool = True):
        try:
            import rlbench  # noqa: F401
            import pyrep  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "RLBenchEnvClient requires rlbench+pyrep+CoppeliaSim on this "
                "host. Use MockEnvClient for simulator-free evaluation, or run "
                "this client on a sim host behind an RPC bridge.") from e
        self.dataset_root = dataset_root
        self.cameras = list(cameras)
        self.image_size = image_size
        self.episode_length = episode_length
        self.headless = headless
        self._env = None
        self._task_env = None
        self._error_counts: Dict[str, int] = {}

    # The implementation mirrors CustomMultiTaskRLBenchEnv; kept separate from
    # the mock so the GPU-side code has zero sim dependencies.
    def launch(self) -> None:
        from rlbench.action_modes.action_mode import MoveArmThenGripper
        from rlbench.action_modes.arm_action_modes import (
            EndEffectorPoseViaPlanning)
        from rlbench.action_modes.gripper_action_modes import Discrete
        from rlbench.environment import Environment
        from rlbench.observation_config import ObservationConfig

        obs_config = ObservationConfig()
        obs_config.set_all(False)
        for cam in self.cameras:
            cc = getattr(obs_config, f"{cam}_camera")
            cc.rgb = True
            cc.depth = True
            cc.point_cloud = True
            cc.image_size = self.image_size
        obs_config.gripper_open = True
        obs_config.gripper_pose = True
        obs_config.gripper_joint_positions = True

        action_mode = MoveArmThenGripper(
            EndEffectorPoseViaPlanning(), Discrete())
        self._env = Environment(action_mode, obs_config=obs_config,
                                dataset_root=self.dataset_root,
                                headless=self.headless)
        self._env.launch()

    def shutdown(self) -> None:
        if self._env is not None:
            self._env.shutdown()

    def set_task(self, task_name: str) -> None:
        from rlbench.backend.utils import task_file_to_task_class
        self._task_env = self._env.get_task(
            task_file_to_task_class(task_name + ".py"))

    def _extract(self, obs, k_index: int) -> EnvObservation:
        rgbs, pcds = [], []
        for c in self.cameras:
            rgbs.append(np.asarray(getattr(obs, f"{c}_rgb"), np.float32) / 255.0)
            pcds.append(np.asarray(getattr(obs, f"{c}_point_cloud"), np.float32))
        time_v = (1.0 - (k_index / float(self.episode_length - 1))) * 2.0 - 1.0
        low_dim = np.array([
            obs.gripper_open,
            *np.clip(obs.gripper_joint_positions, 0.0, 0.04),
            time_v], np.float32)
        return EnvObservation(np.stack(rgbs), np.stack(pcds), low_dim)

    def reset_to_demo(self, episode_index: int) -> EnvObservation:
        demos = self._task_env.get_demos(
            1, live_demos=False, from_episode_number=episode_index,
            random_selection=False)
        _desc, obs = self._task_env.reset_to_demo(demos[0])
        self._step_i = 0
        return self._extract(obs, 0)

    def step(self, action: np.ndarray) -> EnvStepResult:
        from pyrep.errors import ConfigurationPathError, IKError
        from rlbench.backend.exceptions import InvalidActionError

        self._step_i += 1
        try:
            obs, reward, terminal = self._task_env.step(action[:8])
            return EnvStepResult(self._extract(obs, self._step_i),
                                 float(reward) * REWARD_SCALE, bool(terminal))
        except (IKError, ConfigurationPathError, InvalidActionError) as e:
            name = type(e).__name__
            self._error_counts[name] = self._error_counts.get(name, 0) + 1
            return EnvStepResult(
                EnvObservation(np.zeros((1, 1, 1, 3), np.float32),
                               np.zeros((1, 1, 1, 3), np.float32),
                               np.zeros(4, np.float32)),
                0.0, True, info={"error_type": name})
