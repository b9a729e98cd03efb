"""Gaussian-splat rasterizer: project → bin → sort → tile blend (port of
`manigaussian_tpu/ops/rasterizer.py`, single-level duplication).

  preprocess      ops/gaussian_math.preprocess, vectorized over the batch
  duplicate+sort  each Gaussian emits up to `max_tiles_per_gaussian` tile
                  slots; one sort of the fused (sample·tiles + tile, depth
                  rank) key (unique for live entries, so it need not be stable)
  tile ranges     torch.searchsorted(side="left") on the sorted keys; each
                  tile's list is a contiguous slice of the sorted Gaussian ids
  blend           ops/blend.blend_tiles over the packed attributes

A batch of B views renders as ONE problem of B·T tiles (tile origins
repeated per sample) and B·N Gaussians, so the blend is one launch; per
sample this is the JAX package's vmapped rasterizer. The depth order is a
stable argsort of depth, as `jnp.argsort` (ties change the blend order).

`backend="pallas"` (the default) is the kernel route: `blend_tiles`, which
launches the CUDA kernels on CUDA tensors. `backend="xla"` is the plain
route: the blend's plain PyTorch version on any device.

Static capacities as in JAX: splats past `tile_capacity` in a tile are
dropped (`overflow_splats`), rect slots past `max_tiles_per_gaussian` too
(`overflow_gaussians`); both are returned.

The forward's four stages are named ranges for torch.profiler
("rasterize/preprocess", "rasterize/bin_sort", "rasterize/gather",
"rasterize/blend"); the backward runs on autograd's thread, outside them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from manigaussian_tpu_torch.ops import gaussian_math as gm
from manigaussian_tpu_torch.ops.blend import (blend_tiles,
                                              blend_tiles_reference,
                                              gather_splats)


class RasterizeConfig(NamedTuple):
    width: int = 128
    height: int = 128
    tile: int = 16
    max_tiles_per_gaussian: int = 16
    tile_capacity: int = 2048
    chunk: int = 256
    sh_degree: int = 1
    backend: str = "pallas"


class RenderOutput(NamedTuple):
    color: torch.Tensor             # [..., H, W, 3]
    language_feature: torch.Tensor  # [..., H, W, F]
    radii: torch.Tensor             # [..., N] int32
    final_t: torch.Tensor           # [..., H, W]


class RasterizeExtras(NamedTuple):
    overflow_splats: torch.Tensor     # int: splats dropped by tile_capacity
    overflow_gaussians: torch.Tensor  # int: rect slots dropped by R_cap


def _grid(cfg: RasterizeConfig):
    tiles_x = (cfg.width + cfg.tile - 1) // cfg.tile
    tiles_y = (cfg.height + cfg.tile - 1) // cfg.tile
    return tiles_x, tiles_y, tiles_x * tiles_y


def _build_keys(pre: gm.ProjectedGaussians, cfg: RasterizeConfig):
    """Duplicate each Gaussian into its tile-rect slots and sort by
    (sample, tile, depth). `pre` fields are [B, N, ·]. Returns (sorted keys,
    rank_bits, sorted global Gaussian ids b·N + g, overflow_gaussians);
    invalid entries carry tile B·T (sorted to the end)."""
    b, n = pre.depths.shape
    tiles_x, _, num_tiles = _grid(cfg)
    r_cap = cfg.max_tiles_per_gaussian
    dev = pre.depths.device

    inf = torch.full_like(pre.depths, float("inf"))
    order = torch.sort(torch.where(pre.valid, pre.depths, inf), dim=1,
                       stable=True).indices                       # rank → g
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(n, device=dev).expand(b, n))

    rect_w = (pre.rect_max[..., 0] - pre.rect_min[..., 0]).long()
    slot = torch.arange(r_cap, device=dev)
    rect_w_safe = torch.clamp(rect_w, min=1)[..., None]
    tile_x = pre.rect_min[..., 0:1].long() + slot % rect_w_safe
    tile_y = pre.rect_min[..., 1:2].long() + torch.div(slot, rect_w_safe,
                                                       rounding_mode="floor")
    dup_valid = (slot < pre.tiles_touched[..., None]) & pre.valid[..., None]
    sample = torch.arange(b, device=dev)[:, None, None]
    tile_id = torch.where(dup_valid, sample * num_tiles + tile_y * tiles_x + tile_x,
                          torch.full_like(tile_x, b * num_tiles))
    rank_bits = max(1, (n - 1).bit_length())
    key = (tile_id << rank_bits) | ranks[..., None]
    gidx = (sample * n + torch.arange(n, device=dev)[None, :, None]).expand_as(key)
    sorted_key, perm = torch.sort(key.reshape(-1))
    sorted_gidx = gidx.reshape(-1)[perm]
    overflow = torch.clamp(pre.tiles_touched.long() - r_cap, min=0).sum()
    return sorted_key, rank_bits, sorted_gidx, overflow


def tile_lists(pre: gm.ProjectedGaussians, cfg: RasterizeConfig):
    """Bin and sort: (gidx [B·T, K], in_list [B·T, K], counts [B·T],
    overflow_splats, overflow_gaussians)."""
    b = pre.depths.shape[0]
    sorted_key, rank_bits, sorted_gidx, overflow_g = _build_keys(pre, cfg)
    gidx, in_list, counts, overflow_s = _tile_gather(
        sorted_key, rank_bits, sorted_gidx, b * _grid(cfg)[2],
        cfg.tile_capacity)
    return gidx, in_list, counts, overflow_s, overflow_g


def _tile_gather(sorted_key, rank_bits: int, sorted_gidx, num_tiles: int,
                 k_cap: int):
    """Per-tile front-most splat lists: (gidx [T, K], in_list [T, K],
    counts [T], overflow_splats)."""
    dev = sorted_key.device
    tids = torch.arange(num_tiles + 1, device=dev, dtype=sorted_key.dtype)
    bounds = torch.searchsorted(sorted_key, tids << rank_bits, side="left")
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    k = torch.arange(k_cap, device=dev)
    in_list = k[None, :] < torch.clamp(counts, max=k_cap)[:, None]
    padded = torch.cat([sorted_gidx, sorted_gidx.new_zeros(k_cap)])
    gidx = padded[starts[:, None] + k[None, :]]
    overflow = torch.clamp(counts - k_cap, min=0).sum()
    return gidx, in_list, counts, overflow


def _untile(img: torch.Tensor, cfg: RasterizeConfig, b: int) -> torch.Tensor:
    """[B·T, P, C] tile patches → [B, H, W, C] (row-major tile order)."""
    tiles_x, tiles_y, _ = _grid(cfg)
    c = img.shape[-1]
    img = img.reshape(b, tiles_y, tiles_x, cfg.tile, cfg.tile, c)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(b, tiles_y * cfg.tile,
                                                 tiles_x * cfg.tile, c)
    return img[:, :cfg.height, :cfg.width]


def pack_tiles(pre: gm.ProjectedGaussians, lang: torch.Tensor, gidx, in_list,
               cfg: RasterizeConfig, b: int):
    """The blend's inputs: every per-splat attribute packed channel-first
    [9+F, B·N] and gathered once into attrs [B·T, 9+F, K], with the tiles'
    counts [B·T, 1], pixel origins [B·T, 2] and live slots [B·T, 1, K]."""
    tiles_x, _, num_tiles = _grid(cfg)
    t_ids = torch.arange(num_tiles, device=lang.device).repeat(b)
    origins = torch.stack([(t_ids % tiles_x) * cfg.tile,
                           torch.div(t_ids, tiles_x, rounding_mode="floor")
                           * cfg.tile], dim=-1).float()
    flat = lambda x: x.reshape(b * x.shape[1], *x.shape[2:])
    table = torch.cat([flat(pre.means2d).t(), flat(pre.conic).t(),
                       flat(pre.opacity)[None], flat(pre.rgb).t(),
                       flat(lang).t()], dim=0)
    attrs = gather_splats(table, gidx).transpose(0, 1).contiguous()
    livet = in_list.float()[:, None, :].contiguous()
    counts = in_list.sum(dim=1, dtype=torch.int32)[:, None].contiguous()
    return counts, origins, attrs, livet


def _blend(pre: gm.ProjectedGaussians, lang: torch.Tensor, gidx, in_list,
           cfg: RasterizeConfig, bg: torch.Tensor, b: int):
    """Blend the packed tiles. Returns patches (color [B·T, P, 3],
    lang [B·T, P, F], final_t [B·T, P])."""
    with record_function("rasterize/gather"):
        counts, origins, attrs, livet = pack_tiles(pre, lang, gidx, in_list,
                                                   cfg, b)
    blend = blend_tiles if cfg.backend == "pallas" else blend_tiles_reference
    with record_function("rasterize/blend"):
        color_t, lang_t, logtf = blend(counts, origins, attrs, livet,
                                       lang.shape[-1], cfg.tile,
                                       min(cfg.chunk, gidx.shape[1]))
        final_t = torch.exp(logtf[:, 0, :])
        color = color_t.transpose(1, 2) + final_t[..., None] * bg
    return color, lang_t.transpose(1, 2), final_t


def rasterize_batch(means3d: torch.Tensor, opacities: torch.Tensor, camera,
                    cfg: RasterizeConfig, bg_color, scales: torch.Tensor,
                    rotations: torch.Tensor, shs: torch.Tensor,
                    language_features=None, scale_modifier: float = 1.0):
    """Render B views, one per sample: means3d [B, N, 3], opacities [B, N],
    `camera` a batched Camera. Differentiable. Returns (RenderOutput with
    [B, ...] fields, RasterizeExtras)."""
    if cfg.backend not in ("pallas", "xla"):
        raise ValueError(f"unknown rasterizer backend {cfg.backend!r}")
    b, n, _ = means3d.shape
    with record_function("rasterize/preprocess"):
        pre = gm.preprocess(means3d, opacities, camera, cfg.width, cfg.height,
                            cfg.tile, scales=scales, rotations=rotations,
                            shs=shs, sh_degree=cfg.sh_degree,
                            scale_modifier=scale_modifier)
    with record_function("rasterize/bin_sort"):
        gidx, in_list, _, overflow_s, overflow_g = tile_lists(pre, cfg)
    lang = (means3d.new_zeros(b, n, 3) if language_features is None
            else language_features)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    color_p, lang_p, final_t_p = _blend(pre, lang, gidx, in_list, cfg, bg, b)
    out = RenderOutput(color=_untile(color_p, cfg, b),
                       language_feature=_untile(lang_p, cfg, b),
                       radii=pre.radii,
                       final_t=_untile(final_t_p[..., None], cfg, b)[..., 0])
    return out, RasterizeExtras(overflow_s, overflow_g)


def rasterize(means3d, opacities, camera, cfg: RasterizeConfig, bg_color,
              scales, rotations, shs, language_features=None,
              scale_modifier: float = 1.0):
    """One view (the JAX `rasterize`): `rasterize_batch` with B = 1."""
    cam = type(camera)(*(f[None] for f in camera))
    lang = None if language_features is None else language_features[None]
    out, extras = rasterize_batch(means3d[None], opacities[None], cam, cfg,
                                  bg_color, scales[None], rotations[None],
                                  shs[None], lang, scale_modifier)
    return RenderOutput(*(f[0] for f in out)), extras
