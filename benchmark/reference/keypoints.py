"""Keyframe discovery from demonstrations.

Parity target: `helpers/demo_loading_utils.py:8-62` (keypoint_discovery):
  * 'heuristic' — a step is a keypoint if the gripper state changed, it is the
    last step, or the arm is stopped (joint velocities ≈ 0, gripper unchanged in
    a ±2 window, 4-step refractory buffer, and not the second-to-last step);
    trailing duplicate (k[-2] == k[-1]-1) removed;
  * 'random' — 20 sorted random indices;
  * 'fixed_interval' — every len//20 steps.

Operates on plain arrays (gripper_open [T], joint_velocities [T, J]) — no
rlbench Demo class dependency.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _is_stopped(i: int, gripper_open: np.ndarray, joint_velocities: np.ndarray,
                stopped_buffer: int, delta: float) -> bool:
    t = len(gripper_open)
    next_is_not_final = i == (t - 2)
    gripper_state_no_change = (
        i < (t - 2)
        and (gripper_open[i] == gripper_open[i + 1]
             and gripper_open[i] == gripper_open[i - 1]
             and gripper_open[i - 2] == gripper_open[i - 1]))
    small_delta = np.allclose(joint_velocities[i], 0, atol=delta)
    return (stopped_buffer <= 0 and small_delta
            and not next_is_not_final and gripper_state_no_change)


def keypoint_discovery(gripper_open: np.ndarray,
                       joint_velocities: np.ndarray,
                       stopping_delta: float = 0.1,
                       method: str = "heuristic",
                       rng: np.random.Generator | None = None) -> List[int]:
    t = len(gripper_open)
    if method == "heuristic":
        keypoints: List[int] = []
        prev_open = gripper_open[0]
        stopped_buffer = 0
        for i in range(t):
            stopped = _is_stopped(i, gripper_open, joint_velocities,
                                  stopped_buffer, stopping_delta)
            stopped_buffer = 4 if stopped else stopped_buffer - 1
            last = i == (t - 1)
            if i != 0 and (gripper_open[i] != prev_open or last or stopped):
                keypoints.append(i)
            prev_open = gripper_open[i]
        if len(keypoints) > 1 and keypoints[-1] - 1 == keypoints[-2]:
            keypoints.pop(-2)
        return keypoints
    if method == "random":
        rng = rng or np.random.default_rng()
        ks = rng.choice(range(t), size=min(20, t), replace=False)
        return sorted(int(k) for k in ks)
    if method == "fixed_interval":
        seg = max(1, t // 20)
        return list(range(0, t, seg))
    raise NotImplementedError(method)
