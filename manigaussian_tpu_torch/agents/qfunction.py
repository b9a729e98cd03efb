"""QFunction: voxelize → Perceiver Q-heads → (auxiliary) Gaussian-splat
rendering, and the argmax decode.

Port of `manigaussian_tpu/agents/qfunction.py`: `build_voxel_grid` (:44-54),
the perceiver call (:150-156), the Gaussian renderer branch (:114-129,
164-175), the GNFactor NeRF branch (:97-112, 158-216) and
`choose_highest_action` (:218-237). One module owns the policy (`qnet`) and,
when the config renders, the renderer (`neural_renderer`), as the JAX
parameter tree does. The voxel grid carries no gradient (`qfunction.py:151`).

Multi-device: `mesh` is a sharded step's mesh, on this rank's rows of
the global batch (the dropout and NeRF draws are made for the global batch,
the renderers' batch statistics taken over the data group); `tile_mesh`
shards the splat renderer's image tiles (JAX `QFunction(tile_mesh=)`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from manigaussian_tpu_torch.config import MethodConfig
from manigaussian_tpu_torch.models.perceiver import PerceiverVoxelLangEncoder
from manigaussian_tpu_torch.ops.voxelize import voxelize
from manigaussian_tpu_torch.rendering.nerf_renderer import \
    GNFactorNeRFRenderer
from manigaussian_tpu_torch.rendering.neural_renderer import (NeuralRenderer,
                                                              RenderLosses,
                                                              RenderResult)
from manigaussian_tpu_torch.utils.profiling import trace_annotation


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


def renderer_from_config(m: MethodConfig):
    """The JAX QFunction._renderer field mapping, or `_nerf_renderer`'s
    for `renderer_type == "nerf"` (whose MLP reads `neural_renderer.mlp`;
    the Gaussian regressor does not)."""
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
                generator: Optional[torch.Generator] = None, mesh=None,
                tile_mesh=None) -> QOutput:
        with torch.no_grad(), trace_annotation("policy/voxelize"):
            voxel_grid = build_voxel_grid(pcd, rgb, bounds,
                                          self.cfg.voxel_sizes[0])
        rows = None if mesh is None else mesh.rows(rgb.shape[0])
        q_trans, q_rot_grip, q_coll, d0, _lang = self.qnet(
            voxel_grid, proprio, lang_goal_emb, lang_token_embs,
            deterministic=deterministic, generator=generator, rows=rows)
        render_losses = render_result = None
        if (use_neural_rendering
                and isinstance(self.neural_renderer, GNFactorNeRFRenderer)):
            render_losses, render_result = self._nerf_branch(
                d0, nerf_target_rgb, nerf_target_pose, nerf_target_intrinsic,
                gt_embed, deterministic, generator, rows, mesh)
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
                training=nerf_target_rgb is not None, mesh=mesh,
                tile_mesh=tile_mesh)
        return QOutput(q_trans, q_rot_grip, q_coll, voxel_grid,
                       render_losses, render_result)

    def _nerf_branch(self, d0, gt_rgb, gt_pose, gt_intrinsic, gt_embed,
                     deterministic: bool, generator, rows=None, mesh=None):
        """The GNFactor auxiliary loss: volume-render a random ray chunk
        against the target view, returned as the splat path's RenderLosses
        (zero dyna loss and overflow counts). Without a target image but with
        its pose, the full image for visualization (draws from a generator
        seeded 0, as JAX's PRNGKey(0)). Training draws come from `generator`;
        a deterministic call takes them from a generator seeded 0. Without
        `gt_embed` a zero embedding of `d_embed` channels stands in and the
        embed terms stay out of the loss."""
        renderer = self.neural_renderer
        if gt_rgb is None:
            if gt_pose is None:
                return None, None
            rgb, _ = renderer.render_image(d0[0], gt_pose[0], gt_intrinsic[0],
                                           torch.Generator().manual_seed(0))
            return None, RenderResult(render_novel=rgb[None],
                                      next_render_novel=None,
                                      render_embed=None)
        if deterministic:
            generator = torch.Generator().manual_seed(0)
        elif generator is None:
            raise ValueError("the NeRF's training draws need a generator")
        have_embed = gt_embed is not None
        if not have_embed:
            gt_embed = gt_rgb.new_zeros(*gt_rgb.shape[:3], renderer.d_embed)
        nl = renderer(d0, gt_rgb, gt_pose, gt_intrinsic, gt_embed, generator,
                      training=not deterministic, rows=rows, mesh=mesh)
        zero = nl.loss.new_zeros(())
        loss_rgb = nl.loss_rgb_coarse + nl.loss_rgb_fine
        losses = RenderLosses(
            loss=nl.loss if have_embed else loss_rgb, loss_rgb=loss_rgb,
            loss_embed=(nl.loss_embed_coarse + nl.loss_embed_fine
                        if have_embed else zero),
            loss_dyna=zero, psnr=nl.psnr,
            overflow_splats=torch.zeros((), dtype=torch.int32,
                                        device=zero.device),
            overflow_gaussians=torch.zeros((), dtype=torch.int32,
                                           device=zero.device))
        return losses, None


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
