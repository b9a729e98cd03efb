"""QFunction, policy part: voxelize → Perceiver Q-heads → argmax decode.

Port of `manigaussian_tpu/agents/qfunction.py`: `build_voxel_grid` (:44-54),
the perceiver call (:150-156) and `choose_highest_action` (:218-237). The
renderer branches (Gaussian splats, GNFactor NeRF) arrive with the training
slice; `QFunction` therefore owns only the `qnet` subtree of the JAX
parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from manigaussian_tpu_torch.config import MethodConfig
from manigaussian_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from manigaussian_tpu_torch.ops.voxelize import voxelize


class QOutput(NamedTuple):
    q_trans: torch.Tensor       # [B, V, V, V, 1]
    q_rot_grip: torch.Tensor    # [B, 3R+2]
    q_collision: torch.Tensor   # [B, 2]
    voxel_grid: torch.Tensor    # [B, V, V, V, 10]


def build_voxel_grid(pcd: torch.Tensor, rgb: torch.Tensor,
                     bounds: torch.Tensor, voxel_size: int) -> torch.Tensor:
    """Multi-camera point clouds + RGB ([B, ncam, H, W, 3], rgb in [-1, 1])
    → [B, V, V, V, 10] voxel grid."""
    b = pcd.shape[0]
    return voxelize(pcd.reshape(b, -1, 3), rgb.reshape(b, -1, 3), bounds,
                    voxel_size)


def perceiver_from_config(m: MethodConfig) -> PerceiverVoxelLangEncoder:
    """The JAX QFunction._perceiver field mapping."""
    return PerceiverVoxelLangEncoder(
        dtype=getattr(torch, m.policy_dtype),
        pad_mode=m.policy_pad_mode,
        conv_impl=m.policy_conv_impl,
        attn_impl=m.policy_attn_impl,
        depth=m.transformer_depth,
        iterations=m.transformer_iterations,
        voxel_size=m.voxel_sizes[0],
        initial_dim=10,
        low_dim_size=4,
        num_rotation_classes=int(360 // m.rotation_resolution),
        num_latents=m.num_latents,
        im_channels=m.final_dim,
        latent_dim=m.latent_dim,
        cross_heads=m.cross_heads,
        latent_heads=m.latent_heads,
        cross_dim_head=m.cross_dim_head,
        latent_dim_head=m.latent_dim_head,
        activation=m.activation,
        lang_emb_dim=m.language_model_dim,
        voxel_patch_size=m.voxel_patch_size,
        voxel_patch_stride=m.voxel_patch_stride,
        final_dim=m.final_dim,
        no_skip_connection=m.no_skip_connection,
        no_perceiver=m.no_perceiver,
        no_language=m.no_language)


class QFunction(nn.Module):
    def __init__(self, cfg: MethodConfig):
        super().__init__()
        self.cfg = cfg
        self.qnet = perceiver_from_config(cfg)

    def forward(self, rgb, pcd, proprio, lang_goal_emb, lang_token_embs,
                bounds) -> QOutput:
        voxel_grid = build_voxel_grid(pcd, rgb, bounds, self.cfg.voxel_sizes[0])
        q_trans, q_rot_grip, q_coll, _d0, _lang = self.qnet(
            voxel_grid, proprio, lang_goal_emb, lang_token_embs)
        return QOutput(q_trans, q_rot_grip, q_coll, voxel_grid)


def choose_highest_action(q_trans: torch.Tensor, q_rot_grip: torch.Tensor,
                          q_collision: torch.Tensor, rotation_resolution: int):
    """argmax decode (qattention:165-188); q_trans [B, V, V, V, 1].

    Returns (coords [B,3] int32, rot_grip [B,4] int32, collision [B,1] int32);
    ties resolve to the first index, as jnp.argmax does."""
    b, v = q_trans.shape[0], q_trans.shape[1]
    idx = torch.argmax(q_trans.reshape(b, -1), dim=-1)
    coords = torch.stack([idx // (v * v), (idx // v) % v, idx % v],
                         dim=-1).to(torch.int32)
    nrot = int(360 // rotation_resolution)
    rot_idx = torch.argmax(q_rot_grip[:, : nrot * 3].reshape(b, 3, nrot), dim=-1)
    grip_idx = torch.argmax(q_rot_grip[:, nrot * 3:], dim=-1, keepdim=True)
    coll_idx = torch.argmax(q_collision, dim=-1, keepdim=True)
    return (coords, torch.cat([rot_idx, grip_idx], dim=-1).to(torch.int32),
            coll_idx.to(torch.int32))
