"""ManiGaussian behavior-cloning agent: the greedy policy `act`.

Port of `manigaussian_tpu/agents/bc_agent.py`: `normalize_rgb` (:75-77) and
`act` (:209-233), i.e. reference qattention:1063-1158 plus the stack
agent's continuous-action assembly. The JAX agent is functional (params are
passed in); here the agent owns its QFunction module, whose weights come
from a seed (`torch.Generator`), a checkpoint, or `convert.py`. The train
step arrives with the training slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from manigaussian_tpu_torch.agents.qfunction import (QFunction, QOutput,
                                                     choose_highest_action)
from manigaussian_tpu_torch.config import ManiGaussianConfig
from manigaussian_tpu_torch.models.blocks import initialize
from manigaussian_tpu_torch.ops.rotation import discrete_euler_to_quaternion
from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device


class ActResult(NamedTuple):
    continuous_action: torch.Tensor   # [B, 9]: xyz(3) quat_xyzw(4) grip(1) collision(1)
    trans_coords: torch.Tensor        # [B, 3] int32 voxel index
    rot_grip_indices: torch.Tensor    # [B, 4] int32
    collision_indices: torch.Tensor   # [B, 1] int32


def normalize_rgb(rgb_01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB → [-1,1] (helpers/preprocess_agent.py:25-26)."""
    return rgb_01 * 2.0 - 1.0


OBS_KEYS = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")


class ManiGaussianBCAgent:
    """Holds the config, the device and the QFunction (in eval mode)."""

    def __init__(self, cfg: ManiGaussianConfig, device: DeviceLike = None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        # weights are drawn on the CPU so one seed gives one net on any device
        self.qfn = initialize(QFunction(cfg.method),
                              torch.Generator().manual_seed(seed))
        self.qfn.to(self.device).eval()
        self.bounds = torch.tensor(cfg.rlbench.scene_bounds,
                                   dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def q_values(self, observation: Dict) -> QOutput:
        """The QFunction's outputs for one batched observation (act's first
        half, exposed for parity checks)."""
        o = {k: torch.as_tensor(observation[k], dtype=torch.float32,
                                device=self.device) for k in OBS_KEYS}
        return self.qfn(normalize_rgb(o["rgb"]), o["pcd"], o["low_dim_state"],
                        o["lang_goal_emb"], o["lang_token_embs"], self.bounds)

    @torch.no_grad()
    def act(self, observation: Dict) -> ActResult:
        """Greedy policy. observation: rgb [B,ncam,H,W,3] in [0,1], pcd,
        low_dim_state, lang_goal_emb, lang_token_embs (numpy or tensors)."""
        m = self.cfg.method
        q = self.q_values(observation)
        coords, rot_grip, coll = choose_highest_action(
            q.q_trans, q.q_rot_grip, q.q_collision, m.rotation_resolution)

        bounds = self.bounds
        vsize = torch.tensor(float(m.voxel_sizes[0]), device=self.device)
        res = (bounds[3:] - bounds[:3]) / vsize
        # attention coordinate = voxel center (qattention:1120-1123)
        attention_coord = bounds[:3] + res * coords.to(torch.float32) + res / 2
        quat = discrete_euler_to_quaternion(rot_grip[:, :3],
                                            float(m.rotation_resolution))
        continuous = torch.cat(
            [attention_coord, quat, rot_grip[:, 3:4].to(torch.float32),
             coll.to(torch.float32)], dim=-1)
        return ActResult(continuous, coords, rot_grip, coll)
