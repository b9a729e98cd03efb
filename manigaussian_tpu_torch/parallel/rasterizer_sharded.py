"""The splat renderer with its image tiles sharded over the ranks of a mesh
axis (counterpart of `manigaussian_tpu/parallel/rasterizer_sharded.py`).

Contract of the JAX function, per rank of the `tile` group of T ranks:
  * the per-Gaussian preprocess runs on every rank, on inputs that pass
    through `replicate` (identity forward; on the way back the group sums
    the parts of each Gaussian's gradient that its tiles give);
  * rank t owns the contiguous window of num_tiles / T global tiles starting
    at t·num_tiles / T of every sample: it bins only the duplicates that land
    there (`ops/rasterizer.tile_lists` with `tile_range`) and blends them
    with the blend kernel (`ops/blend.blend_tiles`, which takes each tile's
    pixel origin, so a window needs nothing of its own);
  * the patches come back through `gather_patches` (one collective for
    color, features and final transmittance), whose backward hands each
    rank only the gradient of its own patches;
  * `overflow_splats` is summed over the group; `overflow_gaussians` comes
    from the replicated preprocess and is the same on every rank.

Requires num_tiles % T == 0. A batch of B views renders as one problem of
B·num_tiles / T tiles a rank, as `rasterize_batch` does for all tiles.
"""

from __future__ import annotations

import torch

from manigaussian_tpu_torch.ops import gaussian_math as gm
from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                   RasterizeExtras,
                                                   RenderOutput, _blend,
                                                   _grid, _untile, tile_lists)
from manigaussian_tpu_torch.parallel.distributed import (all_reduce,
                                                         gather_patches,
                                                         replicate)


def rasterize_sharded(mesh, means3d: torch.Tensor, opacities: torch.Tensor,
                      camera, cfg: RasterizeConfig, bg_color,
                      scales: torch.Tensor, rotations: torch.Tensor,
                      shs: torch.Tensor, language_features=None,
                      axis: str = "tile"):
    """Render B views (means3d [B, N, 3], a batched Camera) with the tiles
    sharded over `axis` of `mesh`. Differentiable; returns what
    `rasterize_batch` returns, the full images on every rank of the group
    and the group's overflow counters."""
    b, n, _ = means3d.shape
    num_tiles = _grid(cfg)[2]
    group, t, r = mesh.group(axis), mesh.size(axis), mesh.index(axis)
    if num_tiles % t:
        raise ValueError(f"{num_tiles} tiles do not divide over {t} ranks")
    n_local = num_tiles // t
    window = (r * n_local, n_local)
    lang = (means3d.new_zeros(b, n, 3) if language_features is None
            else language_features)
    means3d, opacities, scales, rotations, shs, lang = replicate(
        group, means3d, opacities, scales, rotations, shs, lang)
    pre = gm.preprocess(means3d, opacities, camera, cfg.width, cfg.height,
                        cfg.tile, scales=scales, rotations=rotations, shs=shs,
                        sh_degree=cfg.sh_degree)
    gidx, in_list, _, overflow_s, overflow_g = tile_lists(pre, cfg, window)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    color_p, lang_p, final_t_p = _blend(pre, lang, gidx, in_list, cfg, bg, b,
                                        window)
    f = lang_p.shape[-1]
    patches = torch.cat([color_p, lang_p, final_t_p[..., None]], dim=-1)
    full = gather_patches(patches.contiguous(), group, means3d)
    # full: [t·B·n_local, P, C]
    p, c = full.shape[1:]
    full = full.reshape(t, b, n_local, p, c).transpose(0, 1).reshape(
        b * num_tiles, p, c)
    out = RenderOutput(color=_untile(full[..., :3], cfg, b),
                       language_feature=_untile(full[..., 3:3 + f], cfg, b),
                       radii=pre.radii,
                       final_t=_untile(full[..., 3 + f:], cfg, b)[..., 0])
    return out, RasterizeExtras(all_reduce(overflow_s, "sum", group),
                                overflow_g)
