"""The oracle Gaussian-splat rasterizer in plain PyTorch (a copy of
`manigaussian_tpu/ops/rasterizer_ref.py`).

Every Gaussian is evaluated at every pixel, untiled, O(N·H·W) memory, so it
serves small problems only: the golden fixtures (`scripts/make_goldens`).
The production route is `ops/rasterizer.py`.

Semantics replicate the reference CUDA `renderCUDA` loop (forward.cu:262-398):
front-to-back order by view-space depth; a splat skipped where power > 0 or
alpha < 1/255; alpha = min(0.99, opacity · exp(power)); the termination
latch when T·(1 − alpha) < 1e-4 (the triggering splat does not contribute
and T freezes); a splat evaluated only at pixels whose tile lies in its
binned tile rect; out_color = C + final_T · bg, the embedding channels with
no background (forward.cu:388-394). The blend is the JAX oracle's, op for
op: transmittance as exp of a cumulative sum of log1p(−alpha), the colors
and features as one fp32 matmul. Gradients come from autograd through this
forward, so the masks gate them as the reference's backward does
(backward.cu:398-593).
"""

from __future__ import annotations

from typing import Optional

import torch

from manigaussian_tpu_torch.ops import gaussian_math as gm
from manigaussian_tpu_torch.ops.rasterizer import RenderOutput

ALPHA_MAX = 0.99          # forward.cu:353
ALPHA_MIN = 1.0 / 255.0   # forward.cu:354
T_EPS = 1e-4              # forward.cu:357


def effective_alpha(power: torch.Tensor, opacity: torch.Tensor,
                    extra_mask: torch.Tensor) -> torch.Tensor:
    """CUDA per-pixel alpha with every skip rule folded in as alpha = 0."""
    power_safe = torch.clamp(power, max=0.0)  # power > 0 skipped; no overflow
    alpha = torch.clamp(opacity * torch.exp(power_safe), max=ALPHA_MAX)
    active = (power <= 0.0) & (alpha >= ALPHA_MIN) & extra_mask
    return torch.where(active, alpha, torch.zeros_like(alpha))


def blend_weights(alphas: torch.Tensor):
    """Front-to-back blend weights with the termination latch. alphas
    [..., K] in depth order → (weights [..., K], final_T [...])."""
    log1m = torch.log1p(-alphas)
    csum_incl = torch.cumsum(log1m, dim=-1)
    t_before = torch.exp(csum_incl - log1m)      # exclusive prefix product
    fail = t_before * (1.0 - alphas) < T_EPS
    fail_i = fail.to(torch.int32)
    terminated_before = (torch.cumsum(fail_i, dim=-1) - fail_i) > 0
    contrib = ~terminated_before & ~fail
    zero = torch.zeros_like(alphas)
    weights = torch.where(contrib, alphas * t_before, zero)
    final_t = torch.exp(torch.sum(torch.where(contrib, log1m, zero), dim=-1))
    return weights, final_t


def rasterize_reference(means3d: torch.Tensor, opacities: torch.Tensor,
                        camera, width: int, height: int, bg_color,
                        scales: torch.Tensor, rotations: torch.Tensor,
                        shs: torch.Tensor,
                        language_features: Optional[torch.Tensor] = None,
                        sh_degree: int = 1, scale_modifier: float = 1.0,
                        tile: int = 16) -> RenderOutput:
    """Render one view (see the module docstring)."""
    pre = gm.preprocess(means3d, opacities, camera, width, height, tile,
                        scales=scales, rotations=rotations, shs=shs,
                        sh_degree=sh_degree, scale_modifier=scale_modifier)
    sort_depth = torch.where(pre.valid, pre.depths,
                             torch.full_like(pre.depths, float("inf")))
    order = torch.sort(sort_depth, stable=True).indices
    xy, conic = pre.means2d[order], pre.conic[order]
    opac, rgb = pre.opacity[order], pre.rgb[order]
    rect_min, rect_max = pre.rect_min[order], pre.rect_max[order]
    valid = pre.valid[order]

    dev = means3d.device
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([px, py], -1).reshape(-1, 2)                  # [P, 2]
    tile_xy = torch.stack([torch.div(px, tile, rounding_mode="floor"),
                           torch.div(py, tile, rounding_mode="floor")],
                          -1).to(torch.int32).reshape(-1, 2)

    d = xy[None, :, :] - pix[:, None, :]                            # [P, N, 2]
    power = (-0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                     + conic[None, :, 2] * d[..., 1] ** 2)
             - conic[None, :, 1] * d[..., 0] * d[..., 1])           # [P, N]
    in_rect = ((tile_xy[:, None, 0] >= rect_min[None, :, 0])
               & (tile_xy[:, None, 0] < rect_max[None, :, 0])
               & (tile_xy[:, None, 1] >= rect_min[None, :, 1])
               & (tile_xy[:, None, 1] < rect_max[None, :, 1]))
    alphas = effective_alpha(power, opac[None, :], in_rect & valid[None, :])
    weights, final_t = blend_weights(alphas)                        # [P, N]

    color = weights @ rgb                                           # [P, 3]
    bg = torch.as_tensor(bg_color, dtype=color.dtype, device=dev)
    color = color + final_t[:, None] * bg[None, :]
    lang = (weights @ language_features[order]
            if language_features is not None
            else torch.zeros_like(color))
    return RenderOutput(color=color.reshape(height, width, -1),
                        language_feature=lang.reshape(height, width, -1),
                        radii=pre.radii,
                        final_t=final_t.reshape(height, width))
