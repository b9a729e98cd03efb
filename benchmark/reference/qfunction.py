"""QFunction, plain PyTorch: a frozen copy of the port's
`agents/qfunction.py` without the multi-device paths and the NeRF's
full-image render. voxelize → Perceiver Q-heads → (auxiliary) Gaussian-splat
rendering, or GNFactor's NeRF on a random ray chunk (`renderer_type`
"nerf"). `m` is the configuration's `method` group as attributes
(`benchmark.harness.namespace`); `compute` replaces its policy dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .perceiver import PerceiverVoxelLangEncoder
from .voxelize import voxelize
from .nerf_renderer import GNFactorNeRFRenderer
from .neural_renderer import (NeuralRenderer,
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


def perceiver_from_config(m, compute=None) -> PerceiverVoxelLangEncoder:
    """The port's field mapping of the policy."""
    return PerceiverVoxelLangEncoder(
        dtype=compute or getattr(torch, m.policy_dtype),
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


def renderer_from_config(m):
    """The port's field mapping of the Gaussian renderer, or of the NeRF
    for `renderer_type` "nerf" (whose MLP reads `neural_renderer.mlp`)."""
    r = m.neural_renderer
    if r.renderer_type == "nerf":
        return GNFactorNeRFRenderer(
            coordinate_bounds=tuple(r.coordinate_bounds),
            image_width=r.image_width, image_height=r.image_height,
            z_near=r.znear, z_far=r.zfar, n_coarse=r.n_coarse,
            n_fine=r.n_fine, n_fine_depth=r.n_fine_depth,
            depth_std=r.depth_std, ray_chunk_size=r.ray_chunk_size,
            d_latent=r.d_latent, d_embed=r.d_embed, d_hidden=r.mlp.d_hidden,
            n_blocks=r.mlp.n_blocks, combine_layer=r.mlp.combine_layer,
            lambda_rgb=r.lambda_rgb, lambda_embed=r.lambda_embed,
            noise_std=r.noise_std, white_bkgd=r.white_bkgd)
    if r.renderer_type != "gaussian":
        raise ValueError(f"unknown renderer_type {r.renderer_type!r}")
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
    def __init__(self, m, compute=None):
        super().__init__()
        self.cfg = m
        self.qnet = perceiver_from_config(m, compute)
        self.neural_renderer = (renderer_from_config(m)
                                if m.use_neural_rendering else None)

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
        if (use_neural_rendering
                and isinstance(self.neural_renderer, GNFactorNeRFRenderer)):
            render_losses = self._nerf_losses(
                d0, nerf_target_rgb, nerf_target_pose, nerf_target_intrinsic,
                gt_embed, not deterministic, generator)
        elif use_neural_rendering and self.neural_renderer is not None:
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

    def _nerf_losses(self, d0, gt_rgb, gt_pose, gt_intrinsic, gt_embed,
                     training: bool, generator):
        """The GNFactor auxiliary loss on a random ray chunk against the
        target view, as the splat path's RenderLosses: `loss_rgb` and
        `loss_embed` each the coarse plus the fine term, `loss_dyna` 0; the
        draws from `generator`. Without `gt_embed` a zero embedding stands
        in and the embed terms stay out of the loss."""
        renderer = self.neural_renderer
        have_embed = gt_embed is not None
        if not have_embed:
            gt_embed = gt_rgb.new_zeros(*gt_rgb.shape[:3], renderer.d_embed)
        nl = renderer(d0, gt_rgb, gt_pose, gt_intrinsic, gt_embed, generator,
                      training=training)
        zero = nl.loss.new_zeros(())
        loss_rgb = nl.loss_rgb_coarse + nl.loss_rgb_fine
        return RenderLosses(
            loss=nl.loss if have_embed else loss_rgb, loss_rgb=loss_rgb,
            loss_embed=(nl.loss_embed_coarse + nl.loss_embed_fine
                        if have_embed else zero),
            loss_dyna=zero, psnr=nl.psnr, overflow_splats=zero,
            overflow_gaussians=zero)
