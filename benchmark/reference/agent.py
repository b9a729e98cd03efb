"""The behaviour-cloning step and the greedy policy's Q-values, plain
PyTorch: a frozen copy of the port's `agents/bc_agent.update` and
`q_values` on this folder's modules. Weights are drawn from a CPU
`torch.Generator` seeded as the port's agent seeds its own.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import losses as L
from .augmentation import apply_se3_augmentation, sample_se3_draws
from .blocks import FP8, initialize
from .optimizers import Lamb
from .qfunction import QFunction

NERF_KEYS = ("nerf_target_rgb", "nerf_target_pose", "nerf_target_intrinsic",
             "nerf_next_target_rgb", "nerf_next_target_pose",
             "nerf_next_target_intrinsic", "gt_embed", "action")


def control_compute(policy_dtype: str):
    """The control's compute type: the precision next below the one the
    configuration states for the policy's products (float8 for bfloat16,
    bfloat16 for float32)."""
    return {"bfloat16": FP8, "float32": torch.bfloat16}[policy_dtype]


class ReferenceAgent:
    """`cfg` the configuration as attributes. The policy computes in
    float32, or in `compute` (the control's `control_compute`)."""

    def __init__(self, cfg, device, seed: int, compute=None):
        self.cfg = cfg
        m = cfg.method
        self.qfn = initialize(QFunction(m, compute or torch.float32),
                              torch.Generator().manual_seed(seed))
        self.qfn.to(device).eval()
        self.device = device
        self.bounds = torch.tensor(cfg.rlbench.scene_bounds,
                                   dtype=torch.float32, device=device)
        self.opt = Lamb(self.qfn.parameters(), m.lr,
                        weight_decay=m.lambda_weight_l2,
                        grad_clip_norm=m.grad_clip_norm)

    def update(self, b: Dict[str, torch.Tensor], generator: torch.Generator,
               step: int) -> Dict[str, float]:
        """One step on batch `b`; draws from `generator` in the port's
        order. Returns the losses; the gradients stay in `.grad`."""
        m = self.cfg.method
        rgb = b["rgb"].float() * 2.0 - 1.0
        pcd = b["pcd"].float()
        action_trans = b["trans_action_indicies"][:, :3]
        action_rot_grip = b["rot_grip_action_indicies"]
        if m.apply_se3:
            draws = sample_se3_draws(generator, pcd.shape[0], m.aug_rpy,
                                     m.rotation_resolution)
            out = apply_se3_augmentation(
                draws, pcd, b["gripper_pose"].float(), action_trans,
                action_rot_grip, self.bounds, trans_aug_range=m.aug_xyz,
                rot_aug_resolution=m.rotation_resolution,
                voxel_size=m.voxel_sizes[0],
                rot_resolution=m.rotation_resolution)
            action_trans, action_rot_grip, pcd = (out.action_trans,
                                                  out.action_rot_grip, out.pcd)
        nrot = int(360 // m.rotation_resolution)
        v = m.voxel_sizes[0]
        nerf = {k: (b[k].float() if k in b else None) for k in NERF_KEYS}
        self.qfn.train()
        q = self.qfn(rgb, pcd, b["low_dim_state"].float(),
                     b["lang_goal_emb"].float(), b["lang_token_embs"].float(),
                     self.bounds, use_neural_rendering=m.use_neural_rendering,
                     step=step, deterministic=False, generator=generator,
                     **nerf)
        self.qfn.eval()
        bs = q.q_trans.shape[0]
        at = action_trans.long()
        trans_idx = (at[:, 0] * v + at[:, 1]) * v + at[:, 2]
        trans_loss = L.softmax_cross_entropy_with_index(
            q.q_trans.reshape(bs, -1), trans_idx)
        q_rot = q.q_rot_grip[:, :nrot * 3].reshape(bs, 3, nrot)
        rot_loss = sum(L.softmax_cross_entropy_with_index(
            q_rot[:, i], action_rot_grip[:, i]) for i in range(3))
        grip_loss = L.softmax_cross_entropy_with_index(
            q.q_rot_grip[:, nrot * 3:], action_rot_grip[:, 3])
        coll_loss = L.softmax_cross_entropy_with_index(
            q.q_collision, b["ignore_collisions"][:, 0])
        combined = (trans_loss * m.trans_loss_weight
                    + rot_loss * m.rot_loss_weight
                    + grip_loss * m.grip_loss_weight
                    + coll_loss * m.collision_loss_weight)
        total = m.lambda_bc * combined
        metrics = {"trans_loss": trans_loss, "rot_loss": rot_loss,
                   "grip_loss": grip_loss, "collision_loss": coll_loss,
                   "bc_loss": combined}
        r = q.render_losses
        if r is not None:
            total = total + m.neural_renderer.lambda_nerf * r.loss
            metrics.update(rgb_loss=r.loss_rgb, embed_loss=r.loss_embed,
                           dyna_loss=r.loss_dyna)
        metrics["total_loss"] = total
        self.opt.zero_grad()
        total.backward()
        return {k: float(x.detach()) for k, x in metrics.items()}

    @torch.no_grad()
    def q_values(self, obs: Dict[str, torch.Tensor]):
        """(q_trans [B, V³], q_rot_grip [B, 3R+2], q_collision [B, 2])."""
        q = self.qfn(obs["rgb"].float() * 2.0 - 1.0, obs["pcd"].float(),
                     obs["low_dim_state"].float(), obs["lang_goal_emb"].float(),
                     obs["lang_token_embs"].float(), self.bounds)
        return (q.q_trans.reshape(q.q_trans.shape[0], -1), q.q_rot_grip,
                q.q_collision)
