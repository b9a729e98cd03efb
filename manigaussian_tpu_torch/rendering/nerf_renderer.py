"""Generalizable-NeRF renderer, the GNFactor baseline's volume renderer (port
of `manigaussian_tpu/rendering/nerf_renderer.py`; reference
`agents/gnfactor_bc/neural_rendering.py:81-470`, `models_embed.py:228-380`).

Rays from the target camera → stratified coarse samples → per point: the
voxel features trilinearly sampled at its canonical xyz (border clamp,
align_corners=True on [0, 1]³), the positional code of xyz (6 frequencies,
factor 1.5, input included) and the raw view direction into one ResnetFC
(`mlp`, d_out = 4 + d_embed, shared by both passes) → (rgb, σ, embed) →
alpha compositing → the fine pass on the sorted union of the coarse,
importance and depth-guided samples → MSE terms on a random ray chunk.

Every random draw (the ray indices, the coarse jitter, the two importance
uniforms, the depth normals, and σ's noise when `noise_std` > 0) is taken in
one place, `sample_draws`, from an explicit `torch.Generator` on the CPU,
so the card and the CPU see the same draws from one seed. A batch renders
as one problem: sample b's volume is rows [b·V³, (b+1)·V³) of one flat
table. The trilinear gather's backward is a deterministic scatter (a
stable sort of the corner indices and `segment_reduce`, summed in fp32 and
rounded once to the volume's dtype): `index_add_` sums with atomics in an
order that changes from run to run on CUDA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from manigaussian_tpu_torch.models.gaussian_regressor import (
    ResnetFC, positional_encoding)
from manigaussian_tpu_torch.ops.camera import world_to_canonical
from manigaussian_tpu_torch.ops.voxelize import segment_sum

NUM_FREQS = 6
FREQ_FACTOR = 1.5
# rays a chunk of the full-image render (JAX `render_image`)
IMAGE_CHUNK = 4096


class NerfOutputs(NamedTuple):
    rgb: torch.Tensor      # [B, R, 3]
    embed: torch.Tensor    # [B, R, d_embed]
    depth: torch.Tensor    # [B, R]
    weights: torch.Tensor  # [B, R, K]


class NerfLosses(NamedTuple):
    loss: torch.Tensor
    loss_rgb_coarse: torch.Tensor
    loss_rgb_fine: torch.Tensor
    loss_embed_coarse: torch.Tensor
    loss_embed_fine: torch.Tensor
    psnr: torch.Tensor


class NerfDraws(NamedTuple):
    """The random draws of one render, each [B, R, ·] (ray_idx [B, R])."""
    ray_idx: Optional[torch.Tensor]    # int64 in [0, H·W), with replacement
    coarse: torch.Tensor               # U[0, 1), [B, R, n_coarse]
    fine: torch.Tensor                 # U[0, 1), [B, R, n_fine - n_fine_depth]
    fine_jitter: torch.Tensor          # U[0, 1), the same shape
    depth: torch.Tensor                # N(0, 1), [B, R, n_fine_depth]
    noise_coarse: Optional[torch.Tensor] = None   # N(0, 1) σ noise
    noise_fine: Optional[torch.Tensor] = None


def gen_rays(c2w: torch.Tensor, intrinsic: torch.Tensor, width: int,
             height: int, z_near: float, z_far: float) -> torch.Tensor:
    """Camera rays [..., H·W, 8] = (origin 3, unit dir 3, near, far) through
    the integer pixel coordinates, for c2w [..., 4, 4] and intrinsic
    [..., 3, 3] (utils.gen_rays)."""
    kw = dict(dtype=torch.float32, device=c2w.device)
    ys, xs = torch.meshgrid(torch.arange(height, **kw),
                            torch.arange(width, **kw), indexing="ij")
    lead = c2w.shape[:-2]
    fx, fy = intrinsic[..., 0, 0, None, None], intrinsic[..., 1, 1, None, None]
    cx, cy = intrinsic[..., 0, 2, None, None], intrinsic[..., 1, 2, None, None]
    dirs = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                        torch.ones_like(xs).expand(*lead, height, width)],
                       dim=-1).reshape(*lead, -1, 3)
    dirs = dirs @ c2w[..., :3, :3].transpose(-1, -2)
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-9)
    origins = c2w[..., None, :3, 3].expand(dirs.shape)
    near = torch.full((*dirs.shape[:-1], 1), z_near, **kw)
    far = torch.full((*dirs.shape[:-1], 1), z_far, **kw)
    return torch.cat([origins, dirs, near, far], dim=-1)


def _clip(x, lo, hi):
    """`jnp.clip`: max then min, so a value on a bound passes half its
    gradient (the tie rule of both packages' maximum/minimum), where
    `torch.clamp` passes all of it."""
    return torch.minimum(torch.maximum(x, lo), hi)


class _CornerGather(torch.autograd.Function):
    """rows = table[idx]; the backward sums each row's cotangent into its
    table row by `segment_sum` (fixed order), in fp32, rounded once to the
    table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return segment_sum(grad.float(), idx, ctx.n).to(grad.dtype), None


def trilinear_sample(volume: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """volume [B, D, H, W, C] sampled at uvw [B, N, 3] in [0, 1]³ (axis i of
    uvw indexes spatial axis i; align_corners=True; points outside clamp to
    the border) → [B, N, C]. The corners stay in the volume's dtype and the
    weights are fp32, so the product is fp32, as JAX promotes it. This is
    not the Gaussian regressor's sampler, which reads [-1, 1]³ and counts
    corners outside the grid as zero."""
    b, d, h, w, c = volume.shape
    n = uvw.shape[1]
    dev = volume.device
    scale = torch.tensor([d - 1, h - 1, w - 1], dtype=torch.float32, device=dev)
    top = torch.tensor([d - 2, h - 2, w - 2], device=dev)
    pos = _clip(uvw, torch.zeros_like(scale), torch.ones_like(scale)) * scale
    lo = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0), top)
    frac = pos - lo.float()                                      # [B, N, 3]
    base = ((torch.arange(b, device=dev)[:, None] * d + lo[..., 0]) * h
            + lo[..., 1]) * w + lo[..., 2]                       # [B, N]
    offs = torch.tensor([(dx * h + dy) * w + dz for dx in (0, 1)
                         for dy in (0, 1) for dz in (0, 1)], device=dev)
    idx = (base[..., None] + offs).reshape(-1)
    g = _CornerGather.apply(volume.reshape(-1, c), idx).reshape(b, n, 8, c)
    g000, g001, g010, g011, g100, g101, g110, g111 = g.unbind(2)
    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    c00 = g000 * (1 - fz) + g001 * fz
    c01 = g010 * (1 - fz) + g011 * fz
    c10 = g100 * (1 - fz) + g101 * fz
    c11 = g110 * (1 - fz) + g111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


class GeneralizableNerf(nn.Module):
    """Point network: canonical xyz + view direction + sampled voxel latent
    → (rgb 3, σ 1, embed d_embed), in fp32 (models_embed.py:264-380)."""

    def __init__(self, coordinate_bounds, d_latent: int = 128,
                 d_embed: int = 512, d_hidden: int = 512, n_blocks: int = 5,
                 combine_layer: int = 3):
        super().__init__()
        self.coordinate_bounds = tuple(coordinate_bounds)
        d_in = 3 + 2 * NUM_FREQS * 3 + 3
        self.mlp = ResnetFC(d_in, d_out=4 + d_embed, n_blocks=n_blocks,
                            d_latent=d_latent, d_hidden=d_hidden,
                            combine_layer=combine_layer)

    def forward(self, voxel_feat, points, viewdirs):
        """voxel_feat [B, V, V, V, C] (bf16 or fp32); points, viewdirs
        [B, N, 3] world space → [B, N, 4 + d_embed]."""
        canon = world_to_canonical(points, self.coordinate_bounds)
        z_feature = torch.cat([positional_encoding(canon, NUM_FREQS,
                                                   FREQ_FACTOR), viewdirs], -1)
        latent = trilinear_sample(voxel_feat, canon).float()
        return self.mlp(torch.cat([latent, z_feature], dim=-1))


class GNFactorNeRFRenderer(nn.Module):
    """Volume renderer with coarse and fine passes and the GNFactor loss
    head; one `nerf` module serves both passes (share_mlp)."""

    def __init__(self, coordinate_bounds, image_width: int = 128,
                 image_height: int = 128, z_near: float = 0.1,
                 z_far: float = 4.0, n_coarse: int = 64, n_fine: int = 32,
                 n_fine_depth: int = 16, depth_std: float = 0.01,
                 ray_chunk_size: int = 512, d_latent: int = 128,
                 d_embed: int = 512, d_hidden: int = 512, n_blocks: int = 5,
                 combine_layer: int = 3, lambda_rgb: float = 1.0,
                 lambda_embed: float = 0.01, noise_std: float = 0.0,
                 white_bkgd: bool = False):
        super().__init__()
        self.nerf = GeneralizableNerf(coordinate_bounds, d_latent=d_latent,
                                      d_embed=d_embed, d_hidden=d_hidden,
                                      n_blocks=n_blocks,
                                      combine_layer=combine_layer)
        self.image_width, self.image_height = image_width, image_height
        self.z_near, self.z_far = z_near, z_far
        self.n_coarse, self.n_fine = n_coarse, n_fine
        self.n_fine_depth, self.depth_std = n_fine_depth, depth_std
        self.ray_chunk_size, self.d_embed = ray_chunk_size, d_embed
        self.lambda_rgb, self.lambda_embed = lambda_rgb, lambda_embed
        self.noise_std, self.white_bkgd = noise_std, white_bkgd

    # ------------------------------------------------------------- draws
    def sample_draws(self, generator: torch.Generator, b: int, r: int,
                     training: bool, with_rays: bool = True) -> NerfDraws:
        """Every draw of a render of `r` rays for each of `b` samples, from
        `generator` (a CPU generator), on the CPU: `with_rays`, the ray
        indices (uniform with replacement, as `jax.random.randint`); the
        coarse jitter; the importance sampler's two uniforms; the depth
        normals; in training with `noise_std` > 0, σ's noise of each pass."""
        nf = self.n_fine - self.n_fine_depth
        u = lambda k: torch.rand(b, r, k, generator=generator)
        hw = self.image_width * self.image_height
        ray_idx = (torch.randint(0, hw, (b, r), generator=generator)
                   if with_rays else None)
        coarse, fine, fine_jitter = u(self.n_coarse), u(nf), u(nf)
        depth = torch.randn(b, r, self.n_fine_depth, generator=generator)
        noise = (None, None)
        if training and self.noise_std > 0.0:
            k_all = self.n_coarse + self.n_fine
            noise = (torch.randn(b, r, self.n_coarse, generator=generator),
                     torch.randn(b, r, k_all, generator=generator))
        return NerfDraws(ray_idx, coarse, fine, fine_jitter, depth, *noise)

    # ----------------------------------------------------------- sampling
    def _sample_coarse(self, rays, u):
        """Stratified coarse depths [B, R, Kc] (neural_rendering.py:81-99)."""
        near, far = rays[..., 6:7], rays[..., 7:8]
        step = 1.0 / self.n_coarse
        z = torch.linspace(0.0, 1.0 - step, self.n_coarse,
                           device=rays.device) + u * step
        return near * (1 - z) + far * z

    def _sample_fine(self, rays, weights, u, jitter):
        """Importance samples [B, R, Kf - Kfd] from the coarse weights'
        CDF (neural_rendering.py:101-125)."""
        kc = weights.shape[-1]
        w = weights.detach() + 1e-5
        pdf = w / w.sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                         torch.cumsum(pdf, -1)], -1)
        inds = torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                  right=True).float() - 1.0
        z = (torch.clamp(inds, min=0.0) + jitter) / kc
        near, far = rays[..., 6:7], rays[..., 7:8]
        return near * (1 - z) + far * z

    def _sample_fine_depth(self, rays, depth, normal):
        """Gaussian samples around the coarse depth [B, R, Kfd]
        (neural_rendering.py:128-139)."""
        z = depth[..., None] + normal * self.depth_std
        return _clip(z, rays[..., 6:7], rays[..., 7:8])

    # ---------------------------------------------------------- composite
    def _composite(self, voxel_feat, rays, z_samp, noise) -> NerfOutputs:
        """Alpha-composite along the rays (neural_rendering.py:142-273)."""
        b, r, k = z_samp.shape
        deltas = torch.cat([z_samp[..., 1:] - z_samp[..., :-1],
                            rays[..., 7:8] - z_samp[..., -1:]], -1)
        points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
        viewdirs = rays[..., None, 3:6].expand(b, r, k, 3)
        out = self.nerf(voxel_feat, points.reshape(b, r * k, 3),
                        viewdirs.reshape(b, r * k, 3)).reshape(b, r, k, -1)
        rgbs, sigmas, embeds = out[..., :3], out[..., 3], out[..., 4:]
        if noise is not None:
            sigmas = sigmas + noise * self.noise_std
        alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
        shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                             1.0 - alphas + 1e-10], -1)
        transmit = torch.cumprod(shifted, -1)
        weights = alphas * transmit[..., :-1]
        rgb = (weights[..., None] * rgbs).sum(-2)
        embed = (weights[..., None] * embeds).sum(-2)
        depth = (weights * z_samp).sum(-1)
        if self.white_bkgd:
            rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
        return NerfOutputs(rgb, embed, depth, weights)

    # ------------------------------------------------------------ forward
    def render_rays(self, voxel_feat, rays, draws: NerfDraws
                    ) -> Tuple[NerfOutputs, NerfOutputs]:
        """The coarse and the fine pass over rays [B, R, 8] with `draws`
        (on the rays' device) → (coarse, fine) (forward_nerf, :313-350)."""
        z_coarse = self._sample_coarse(rays, draws.coarse)
        coarse = self._composite(voxel_feat, rays, z_coarse, draws.noise_coarse)
        samps = [z_coarse]
        if self.n_fine - self.n_fine_depth > 0:
            samps.append(self._sample_fine(rays, coarse.weights, draws.fine,
                                           draws.fine_jitter))
        if self.n_fine_depth > 0:
            samps.append(self._sample_fine_depth(rays, coarse.depth,
                                                 draws.depth))
        z_all = torch.sort(torch.cat(samps, -1), dim=-1).values
        fine = self._composite(voxel_feat, rays, z_all, draws.noise_fine)
        return coarse, fine

    def forward(self, voxel_feat, gt_rgb, gt_pose, gt_intrinsic, gt_embed,
                generator: torch.Generator, training: bool = True
                ) -> NerfLosses:
        """The training losses on a random chunk of `ray_chunk_size` rays a
        sample (compute_rendering_loss, :410-466): voxel_feat
        [B, V, V, V, C], gt_rgb [B, H, W, 3], gt_pose [B, 4, 4] c2w,
        gt_intrinsic [B, 3, 3], gt_embed [B, H, W, d_embed]."""
        b = voxel_feat.shape[0]
        hw = self.image_height * self.image_width
        dev = voxel_feat.device
        draws = NerfDraws(*(None if x is None else x.to(dev) for x in
                            self.sample_draws(generator, b,
                                              self.ray_chunk_size, training)))
        rays = gen_rays(gt_pose, gt_intrinsic, self.image_width,
                        self.image_height, self.z_near, self.z_far)
        pick = lambda x: torch.gather(
            x, 1, draws.ray_idx[..., None].expand(-1, -1, x.shape[-1]))
        coarse, fine = self.render_rays(voxel_feat, pick(rays), draws)
        gt_c = pick(gt_rgb.reshape(b, hw, 3))
        gt_e = pick(gt_embed.reshape(b, hw, -1))
        mse = lambda a, t: torch.mean((a - t) ** 2)
        l_rgb_c = self.lambda_rgb * mse(coarse.rgb, gt_c)
        l_rgb_f = self.lambda_rgb * mse(fine.rgb, gt_c)
        l_emb_c = self.lambda_embed * mse(coarse.embed, gt_e)
        l_emb_f = self.lambda_embed * mse(fine.embed, gt_e)
        psnr = -10.0 * torch.log10(torch.clamp(mse(fine.rgb, gt_c), min=1e-10))
        return NerfLosses(l_rgb_c + l_rgb_f + l_emb_c + l_emb_f, l_rgb_c,
                          l_rgb_f, l_emb_c, l_emb_f, psnr)

    @torch.no_grad()
    def render_image(self, voxel_feat, pose, intrinsic,
                     generator: torch.Generator):
        """The full image for visualization (rendering(), :352-408): one
        sample (voxel_feat [V, V, V, C], pose [4, 4], intrinsic [3, 3]), in
        chunks of IMAGE_CHUNK rays, the last padded with the first ray; one
        set of draws serves every chunk, as JAX renders each chunk with the
        same key. No graph is kept. Returns (rgb [H, W, 3], depth [H, W])."""
        dev = voxel_feat.device
        rays = gen_rays(pose, intrinsic, self.image_width, self.image_height,
                        self.z_near, self.z_far)
        hw = rays.shape[0]
        pad = (-hw) % IMAGE_CHUNK
        if pad:
            rays = torch.cat([rays, rays[:1].expand(pad, 8)])
        draws = NerfDraws(*(None if x is None else x.to(dev) for x in
                            self.sample_draws(generator, 1, IMAGE_CHUNK, False,
                                              with_rays=False)))
        rgb, depth = [], []
        for rc in rays.reshape(-1, IMAGE_CHUNK, 8):
            _, fine = self.render_rays(voxel_feat[None], rc[None], draws)
            rgb.append(fine.rgb[0])
            depth.append(fine.depth[0])
        rgb = torch.cat(rgb)[:hw].reshape(self.image_height, self.image_width, 3)
        depth = torch.cat(depth)[:hw].reshape(self.image_height,
                                              self.image_width)
        return rgb, depth
