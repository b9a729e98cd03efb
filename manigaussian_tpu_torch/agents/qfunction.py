"""QFunction: voxelize → Perceiver Q-heads → (auxiliary) Gaussian-splat
rendering, and the argmax decode.

Port of `manigaussian_tpu/agents/qfunction.py`: `build_voxel_grid` (:44-54),
the perceiver call (:150-156), the Gaussian renderer branch (:114-129,
164-175) and `choose_highest_action` (:218-237). One module owns the policy
(`qnet`) and, when the config renders, the renderer (`neural_renderer`), as
the JAX parameter tree does. The voxel grid carries no gradient
(`qfunction.py:151`). The GNFactor NeRF branch is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from manigaussian_tpu_torch.config import MethodConfig
from manigaussian_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from manigaussian_tpu_torch.ops.voxelize import voxelize
from manigaussian_tpu_torch.rendering.neural_renderer import (NeuralRenderer,
                                                              RenderLosses,
                                                              RenderResult)


class QOutput(NamedTuple):
    q_trans: torch.Tensor       # [B, V, V, V, 1]
    q_rot_grip: torch.Tensor    # [B, 3R+2]
    q_collision: torch.Tensor   # [B, 2]
    voxel_grid: torch.Tensor    # [B, V, V, V, 10]
    render_losses: Optional[RenderLosses] = None
    render_result: Optional[RenderResult] = None


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
        input_dropout=m.input_dropout,
        attn_dropout=m.attn_dropout,
        decoder_dropout=m.decoder_dropout,
        voxel_patch_size=m.voxel_patch_size,
        voxel_patch_stride=m.voxel_patch_stride,
        final_dim=m.final_dim,
        no_skip_connection=m.no_skip_connection,
        no_perceiver=m.no_perceiver,
        no_language=m.no_language)


def renderer_from_config(m: MethodConfig) -> NeuralRenderer:
    """The JAX QFunction._renderer field mapping."""
    r = m.neural_renderer
    if r.renderer_type != "gaussian":
        raise NotImplementedError(
            f"renderer_type={r.renderer_type!r} (the GNFactor NeRF renderer) "
            "is not ported")
    return NeuralRenderer(
        coordinate_bounds=tuple(r.coordinate_bounds),
        image_width=r.image_width, image_height=r.image_height,
        znear=r.znear, zfar=r.zfar, bg_color=tuple(r.bg_color),
        use_dynamic_field=r.use_dynamic_field,
        use_semantic_feature=(r.foundation_model_name == "diffusion"),
        loss_embed_fn=r.loss_embed_fn, lambda_embed=r.lambda_embed,
        lambda_dyna=r.lambda_dyna, warm_up=r.next_mlp.warm_up,
        d_latent=r.d_latent, tile=r.tile,
        max_tiles_per_gaussian=r.max_tiles_per_gaussian,
        tile_capacity=r.tile_capacity, chunk=r.chunk, backend=r.backend,
        feature_norm_eps=r.feature_norm_eps)


class QFunction(nn.Module):
    def __init__(self, cfg: MethodConfig):
        super().__init__()
        self.cfg = cfg
        self.qnet = perceiver_from_config(cfg)
        self.neural_renderer = (renderer_from_config(cfg)
                                if cfg.use_neural_rendering else None)

    def forward(self, rgb, pcd, proprio, lang_goal_emb, lang_token_embs,
                bounds, use_neural_rendering: bool = False,
                nerf_target_rgb=None, nerf_target_pose=None,
                nerf_target_intrinsic=None, nerf_next_target_rgb=None,
                nerf_next_target_pose=None, nerf_next_target_intrinsic=None,
                gt_embed=None, action=None, step: int = 0,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> QOutput:
        with torch.no_grad():
            voxel_grid = build_voxel_grid(pcd, rgb, bounds,
                                          self.cfg.voxel_sizes[0])
        q_trans, q_rot_grip, q_coll, d0, _lang = self.qnet(
            voxel_grid, proprio, lang_goal_emb, lang_token_embs,
            deterministic=deterministic, generator=generator)
        render_losses = render_result = None
        if use_neural_rendering and self.neural_renderer is not None:
            # front camera only (qattention:252-258)
            front_pcd = pcd[:, 0].reshape(pcd.shape[0], -1, 3)
            render_losses, render_result = self.neural_renderer(
                front_pcd, d0, gt_rgb=nerf_target_rgb, gt_pose=nerf_target_pose,
                gt_intrinsic=nerf_target_intrinsic,
                next_gt_rgb=nerf_next_target_rgb,
                next_gt_pose=nerf_next_target_pose,
                next_gt_intrinsic=nerf_next_target_intrinsic,
                gt_embed=gt_embed, action=action, step=step,
                training=nerf_target_rgb is not None)
        return QOutput(q_trans, q_rot_grip, q_coll, voxel_grid,
                       render_losses, render_result)


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
