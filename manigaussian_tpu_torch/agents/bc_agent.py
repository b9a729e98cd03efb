"""ManiGaussian behavior-cloning agent: the train step `update` and the
greedy policy `act`.

Port of `manigaussian_tpu/agents/bc_agent.py`: the optimizer construction
(:52-72), `normalize_rgb` (:75-77), `update` (:126-206), `act` (:209-233)
and `render_for_vis` (:236-254), i.e. reference qattention:654-1010 and
1063-1158 plus the stack agent's continuous-action assembly. The JAX agent
is functional (params and optimizer state are passed in and returned);
here the agent owns its QFunction module, its LAMB state and its step
count. Weights come from a seed (`torch.Generator`), a checkpoint, or
`convert.py`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from manigaussian_tpu_torch.agents.qfunction import (QFunction, QOutput,
                                                     choose_highest_action)
from manigaussian_tpu_torch.config import ManiGaussianConfig
from manigaussian_tpu_torch.models.blocks import initialize
from manigaussian_tpu_torch.ops import losses as L
from manigaussian_tpu_torch.ops.augmentation import (SE3Draws,
                                                     apply_se3_augmentation,
                                                     sample_se3_draws)
from manigaussian_tpu_torch.ops.rotation import discrete_euler_to_quaternion
from manigaussian_tpu_torch.rendering.neural_renderer import RenderResult
from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device
from manigaussian_tpu_torch.utils.optimizers import Lamb, warmup_cosine_schedule


class ActResult(NamedTuple):
    continuous_action: torch.Tensor   # [B, 9]: xyz(3) quat_xyzw(4) grip(1) collision(1)
    trans_coords: torch.Tensor        # [B, 3] int32 voxel index
    rot_grip_indices: torch.Tensor    # [B, 4] int32
    collision_indices: torch.Tensor   # [B, 1] int32


def normalize_rgb(rgb_01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB → [-1,1] (helpers/preprocess_agent.py:25-26)."""
    return rgb_01 * 2.0 - 1.0


OBS_KEYS = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")
NERF_KEYS = ("nerf_target_rgb", "nerf_target_pose", "nerf_target_intrinsic",
             "nerf_next_target_rgb", "nerf_next_target_pose",
             "nerf_next_target_intrinsic", "gt_embed", "action")


def make_optimizer(cfg: ManiGaussianConfig, params) -> Lamb:
    """Reference LAMB (weight decay `lambda_weight_l2`), with the
    warmup-cosine schedule when `lr_scheduler` is set and the global-norm
    clip when `grad_clip_norm` > 0 (JAX bc_agent.py:52-72)."""
    m = cfg.method
    if m.optimizer != "lamb":
        raise NotImplementedError(f"optimizer {m.optimizer!r} is not ported")
    lr = m.lr
    if m.lr_scheduler:
        lr = warmup_cosine_schedule(m.lr, m.num_warmup_steps,
                                    cfg.framework.training_iterations)
    return Lamb(params, lr, weight_decay=m.lambda_weight_l2,
                grad_clip_norm=m.grad_clip_norm)


class ManiGaussianBCAgent:
    """Holds the config, the device, the QFunction (in eval mode outside
    `update`), the optimizer and the step count."""

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
        self.opt: Optional[Lamb] = None
        self.step = 0

    def optimizer(self) -> Lamb:
        """The LAMB state, made at the first use (act needs none)."""
        if self.opt is None:
            self.opt = make_optimizer(self.cfg, self.qfn.parameters())
        return self.opt

    def update(self, batch: Dict, generator: torch.Generator,
               draws: Optional[SE3Draws] = None) -> Dict[str, torch.Tensor]:
        """One BC step (JAX `update`): normalize; the augmentation draws
        (from `generator`, or `draws` as given) and their application; the
        forward in train mode (dropout from `generator`); the loss dict with
        the JAX metric names; backward; the clip and LAMB step. `batch` holds
        numpy arrays or tensors (the schema of data/pipeline.assemble_batch).
        Returns the metrics as 0-d tensors on the device (no host sync).
        The three stages are named ranges for torch.profiler
        ("update/forward", "update/backward", "update/optimizer")."""
        m = self.cfg.method
        dev = self.device
        b = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                device=dev)
             for k, v in batch.items() if k in OBS_KEYS + NERF_KEYS + (
                 "trans_action_indicies", "rot_grip_action_indicies",
                 "ignore_collisions", "gripper_pose")}
        rgb = normalize_rgb(b["rgb"].float())
        pcd = b["pcd"].float()
        action_trans = b["trans_action_indicies"][:, :3]
        action_rot_grip = b["rot_grip_action_indicies"]
        if m.apply_se3:
            if draws is None:
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
        opt = self.optimizer()
        with record_function("update/forward"):
            self.qfn.train()
            total, metrics = self._losses(b, rgb, pcd, action_trans,
                                          action_rot_grip, generator)
            self.qfn.eval()
        opt.zero_grad()
        with record_function("update/backward"):
            total.backward()
        with record_function("update/optimizer"):
            opt.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _losses(self, b, rgb, pcd, action_trans, action_rot_grip, generator):
        """The train-mode forward and the loss dict (JAX `loss_fn`)."""
        m = self.cfg.method
        nrot = int(360 // m.rotation_resolution)
        v = m.voxel_sizes[0]
        nerf = {k: (b[k].float() if k in b else None) for k in NERF_KEYS}
        q = self.qfn(rgb, pcd, b["low_dim_state"].float(),
                     b["lang_goal_emb"].float(), b["lang_token_embs"].float(),
                     self.bounds, use_neural_rendering=m.use_neural_rendering,
                     step=self.step, deterministic=False, generator=generator,
                     **nerf)
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
                           dyna_loss=r.loss_dyna, psnr=r.psnr,
                           overflow_splats=r.overflow_splats,
                           overflow_gaussians=r.overflow_gaussians)
        metrics["total_loss"] = total
        return total, metrics

    @torch.no_grad()
    def q_values(self, observation: Dict) -> QOutput:
        """The QFunction's outputs for one batched observation (act's first
        half, exposed for parity checks)."""
        o = {k: torch.as_tensor(observation[k], dtype=torch.float32,
                                device=self.device) for k in OBS_KEYS}
        return self.qfn(normalize_rgb(o["rgb"]), o["pcd"], o["low_dim_state"],
                        o["lang_goal_emb"], o["lang_token_embs"], self.bounds)

    @torch.no_grad()
    def render_for_vis(self, batch: Dict) -> Optional[RenderResult]:
        """The inference-mode novel-view render of the recon panels
        (QFunction.render, qattention:289-359): the batch's first target
        view, with no target image, at step 0, deterministic. Returns the
        RenderResult (the NeRF renderer: the full image of sample 0)."""
        keys = OBS_KEYS + ("nerf_target_pose", "nerf_target_intrinsic",
                           "nerf_next_target_pose",
                           "nerf_next_target_intrinsic", "action")
        b = {k: torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(
            batch[k]) else batch[k], device=self.device).float()
             for k in keys if k in batch}
        q = self.qfn(normalize_rgb(b["rgb"]), b["pcd"], b["low_dim_state"],
                     b["lang_goal_emb"], b["lang_token_embs"], self.bounds,
                     use_neural_rendering=True,
                     nerf_target_pose=b.get("nerf_target_pose"),
                     nerf_target_intrinsic=b.get("nerf_target_intrinsic"),
                     nerf_next_target_pose=b.get("nerf_next_target_pose"),
                     nerf_next_target_intrinsic=b.get(
                         "nerf_next_target_intrinsic"),
                     action=b.get("action"), step=0, deterministic=True)
        return q.render_result

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
