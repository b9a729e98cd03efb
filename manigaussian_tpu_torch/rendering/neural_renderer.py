"""NeuralRenderer: voxel features + point cloud → Gaussians → rendered views →
losses (port of `manigaussian_tpu/rendering/neural_renderer.py:58-243`;
reference `neural_rendering.py:30-402`, `gaussian_renderer/__init__.py`).

The batch renders through `ops/rasterizer.rasterize_batch` as one problem of
B·T tiles. The language features are L2-normalized with `feature_norm_eps`
before the blend. The dynamic field's warm-up gate is a Python `if` on the
host step, as the JAX `lax.cond`: before the warm-up the next-frame branch
is not run at all, so its backward is skipped rather than multiplied by 0.
The semantic tier (`foundation_model_name="diffusion"`) is not ported: its
foundation models are not; the renderer raises for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from manigaussian_tpu_torch.models.gaussian_regressor import \
    GeneralizableGSEmbedNet
from manigaussian_tpu_torch.ops import losses as L
from manigaussian_tpu_torch.ops.camera import novel_camera_calib
from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                   rasterize_batch)


class RenderLosses(NamedTuple):
    loss: torch.Tensor
    loss_rgb: torch.Tensor
    loss_embed: torch.Tensor
    loss_dyna: torch.Tensor
    psnr: torch.Tensor
    overflow_splats: torch.Tensor
    overflow_gaussians: torch.Tensor


class RenderResult(NamedTuple):
    render_novel: torch.Tensor              # [B, H, W, 3]
    next_render_novel: Optional[torch.Tensor]
    render_embed: Optional[torch.Tensor]    # [B, H, W, 3]


class NeuralRenderer(nn.Module):
    def __init__(self, coordinate_bounds=(-0.3, -0.5, 0.6, 0.7, 0.5, 1.6),
                 image_width: int = 128, image_height: int = 128,
                 znear: float = 0.1, zfar: float = 4.0, bg_color=(0.0, 0.0, 0.0),
                 use_dynamic_field: bool = False,
                 use_semantic_feature: bool = False,
                 loss_embed_fn: str = "cosine", lambda_embed: float = 0.01,
                 lambda_dyna: float = 0.01, warm_up: int = 3000,
                 d_latent: int = 128, tile: int = 16,
                 max_tiles_per_gaussian: int = 16, tile_capacity: int = 2048,
                 chunk: int = 256, backend: str = "pallas",
                 feature_norm_eps: float = 1e-6):
        super().__init__()
        if use_semantic_feature:
            raise NotImplementedError(
                "the semantic tier (foundation_model_name='diffusion') is not "
                "ported: its foundation models are not")
        self.gs_model = GeneralizableGSEmbedNet(
            coordinate_bounds=coordinate_bounds, d_latent=d_latent,
            use_dynamic_field=use_dynamic_field)
        self.cfg = RasterizeConfig(
            width=image_width, height=image_height, tile=tile,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            tile_capacity=tile_capacity, chunk=chunk, sh_degree=1,
            backend=backend)
        self.znear, self.zfar = znear, zfar
        self.bg_color = tuple(bg_color)
        self.use_dynamic_field = use_dynamic_field
        self.loss_embed_fn, self.lambda_embed = loss_embed_fn, lambda_embed
        self.lambda_dyna, self.warm_up = lambda_dyna, warm_up
        self.feature_norm_eps = feature_norm_eps

    def _cameras(self, intrinsic, pose):
        return novel_camera_calib(intrinsic, pose, self.znear, self.zfar,
                                  self.cfg.height, self.cfg.width)

    def _render(self, params, cameras):
        """Returns (color [B,H,W,3], lang [B,H,W,3], overflow_s, overflow_g)."""
        feat = params["feature"]
        eps = self.feature_norm_eps
        feat = feat / torch.sqrt(torch.clamp((feat * feat).sum(-1, keepdim=True),
                                             min=eps * eps))
        out, extras = rasterize_batch(
            params["xyz"], params["opacity"][..., 0], cameras, self.cfg,
            self.bg_color, scales=params["scale"], rotations=params["rot"],
            shs=params["sh"], language_features=feat)
        return (out.color, out.language_feature, extras.overflow_splats,
                extras.overflow_gaussians)

    def _embed_loss(self, render_embed, gt_embed):
        if self.loss_embed_fn == "l2_norm":
            lo, hi = gt_embed.min(), gt_embed.max()
            return L.l2_loss(render_embed, (gt_embed - lo) / (hi - lo + 1e-12))
        if self.loss_embed_fn == "l2":
            return L.l2_loss(render_embed, gt_embed)
        if self.loss_embed_fn == "cosine":
            return L.cosine_loss(render_embed, gt_embed)
        raise ValueError(f"unknown loss_embed_fn {self.loss_embed_fn}")

    def forward(self, pcd, dec_fts, gt_rgb=None, gt_pose=None,
                gt_intrinsic=None, next_gt_rgb=None, next_gt_pose=None,
                next_gt_intrinsic=None, gt_embed=None, action=None,
                step: int = 0, training: bool = True):
        """pcd [B, N, 3] world points, dec_fts [B, V, V, V, d_latent].
        Returns (RenderLosses, RenderResult)."""
        params = self.gs_model(pcd, dec_fts, action=action)
        render_novel, render_embed, ov_s, ov_g = self._render(
            params, self._cameras(gt_intrinsic, gt_pose))

        next_render = None
        if self.use_dynamic_field and next_gt_pose is not None:
            if step >= self.warm_up:
                next_render, _, _, _ = self._render(
                    params["next"], self._cameras(next_gt_intrinsic, next_gt_pose))
            else:
                next_render = render_novel.new_zeros(render_novel.shape)

        zero = render_novel.new_zeros(())
        if not training or gt_rgb is None:
            losses = RenderLosses(zero, zero, zero, zero, zero, ov_s, ov_g)
            return losses, RenderResult(render_novel, next_render, render_embed)

        loss_rgb = L.l2_loss(render_novel, gt_rgb)
        psnr_v = L.psnr(render_novel, gt_rgb)
        loss = loss_rgb  # enters unweighted, like the reference forward
        loss_embed = zero
        if gt_embed is not None:
            loss_embed = self._embed_loss(render_embed, gt_embed)
            loss = loss + self.lambda_embed * loss_embed
        loss_dyna = zero
        if next_render is not None and next_gt_rgb is not None:
            loss_dyna = L.l2_loss(next_render, next_gt_rgb)
            if step >= self.warm_up:
                loss = loss + self.lambda_dyna * loss_dyna
        return (RenderLosses(loss, loss_rgb, loss_embed, loss_dyna, psnr_v,
                             ov_s, ov_g),
                RenderResult(render_novel, next_render, render_embed))
