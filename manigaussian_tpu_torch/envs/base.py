"""Host-side environment client protocol.

The simulator (CoppeliaSim via PyRep/RLBench in the reference) is a CPU x86
workload — it never runs on TPU. The framework therefore talks to environments
through this thin protocol (SURVEY.md §2.2: 'the framework needs a host-side
env-client abstraction'), with three implementations:

  * MockEnvClient (envs/mock_env.py) — replays stored episodes, used in CI.
  * RLBenchEnvClient (envs/rlbench_env.py) — wraps RLBench/PyRep when installed
    (parity: helpers/custom_rlbench_env.py CustomMultiTaskRLBenchEnv).
  * Any RPC client to a remote sim host (same protocol over the wire).

Error-tolerant step semantics mirror the reference
(custom_rlbench_env.py:333-344): simulator/IK failures terminate the episode
with zero reward and are counted per error type in `info['error_type']`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

import numpy as np


@dataclass
class EnvObservation:
    """What the agent's act() consumes, numpy, unbatched."""

    rgb: np.ndarray              # [ncam, H, W, 3] float32 in [0, 1]
    pcd: np.ndarray              # [ncam, H, W, 3] float32 world points
    low_dim_state: np.ndarray    # [4]
    lang_goal: str = ""
    misc: Dict = field(default_factory=dict)


@dataclass
class EnvStepResult:
    observation: EnvObservation
    reward: float
    terminal: bool
    info: Dict = field(default_factory=dict)


class EnvClient(Protocol):
    def launch(self) -> None: ...

    def shutdown(self) -> None: ...

    def set_task(self, task_name: str) -> None: ...

    def reset_to_demo(self, episode_index: int) -> EnvObservation:
        """Reset the scene to a stored demo's initial state
        (custom_rlbench_env.py:372-392 reset_to_demo parity)."""
        ...

    def step(self, action: np.ndarray) -> EnvStepResult:
        """action: [9] = xyz(3) + quat_xyzw(4) + gripper(1) + ignore_collision(1)."""
        ...
