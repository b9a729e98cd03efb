"""Per-Gaussian math: quaternion→rotation, 3D/2D covariance (EWA), spherical
harmonics and the renderer's per-Gaussian preprocess (port of
`manigaussian_tpu/ops/gaussian_math.py`; reference `forward.cu:21-257`,
`auxiliary.h:41-56`).

Vectorized over the leading dims. Every guard of the JAX module is kept:
the near cull at 0.2, HOM_EPS, the +0.3 low-pass, the 0.1 eigenvalue floor,
and the `where`-substituted safe z and determinant, which keep the gradients
of culled Gaussians free of NaN. All fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from manigaussian_tpu_torch.utils.device import constant

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

NEAR_CULL_Z = 0.2
HOM_EPS = 1e-7
COV2D_LOWPASS = 0.3
FOV_CLAMP = 1.3
EIG_FLOOR = 0.1


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) → 3x3 rotation matrix, batched over leading
    dims. Like the reference (forward.cu:128), q is assumed normalized."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def build_cov3d(scale: torch.Tensor, q: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """Σ = R S² Rᵀ as its upper triangle [σxx, σxy, σxz, σyy, σyz, σzz]
    (computeCov3D)."""
    rot = quat_to_rotmat(q)
    s2 = torch.square(scale * scale_modifier)
    r0, r1, r2 = rot[..., 0, :], rot[..., 1, :], rot[..., 2, :]
    w0, w1, w2 = r0 * s2, r1 * s2, r2 * s2
    return torch.stack([
        (w0 * r0).sum(-1), (w0 * r1).sum(-1), (w0 * r2).sum(-1),
        (w1 * r1).sum(-1), (w1 * r2).sum(-1), (w2 * r2).sum(-1),
    ], dim=-1)


def project_cov2d(mean_view: torch.Tensor, cov3d6: torch.Tensor,
                  view_rot: torch.Tensor, focal_x, focal_y, tan_fovx,
                  tan_fovy) -> torch.Tensor:
    """EWA projection of the 3D covariance (computeCov2D, with the 1.3·tanfov
    clamp and the +0.3 low-pass). mean_view [..., N, 3] in camera space,
    view_rot [..., 3, 3] world→camera rotation, the focal lengths and tans
    [...] (one per view). Returns [..., N, 3]: (cov_xx, cov_xy, cov_yy)."""
    tz = mean_view[..., 2]
    limx = (FOV_CLAMP * tan_fovx)[..., None]
    limy = (FOV_CLAMP * tan_fovy)[..., None]
    tx = torch.clamp(mean_view[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(mean_view[..., 1] / tz, -limy, limy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    fx, fy = focal_x[..., None], focal_y[..., None]
    j00 = fx * inv_tz
    j02 = -fx * tx * inv_tz2
    j11 = fy * inv_tz
    j12 = -fy * ty * inv_tz2
    w0, w1, w2 = (view_rot[..., i, :][..., None, :] for i in range(3))
    t0 = j00[..., None] * w0 + j02[..., None] * w2
    t1 = j11[..., None] * w1 + j12[..., None] * w2
    xx, xy, xz, yy, yz, zz = (cov3d6[..., i] for i in range(6))

    def sig_dot(v):
        return torch.stack([
            xx * v[..., 0] + xy * v[..., 1] + xz * v[..., 2],
            xy * v[..., 0] + yy * v[..., 1] + yz * v[..., 2],
            xz * v[..., 0] + yz * v[..., 1] + zz * v[..., 2],
        ], dim=-1)

    s0, s1 = sig_dot(t0), sig_dot(t1)
    c00 = (t0 * s0).sum(-1)
    c01 = (t0 * s1).sum(-1)
    c11 = (t1 * s1).sum(-1)
    return torch.stack([c00 + COV2D_LOWPASS, c01, c11 + COV2D_LOWPASS], dim=-1)


def eval_sh(sh: torch.Tensor, deg: int,
            dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real SH at (normalized) directions, +0.5, clamped at 0
    (computeColorFromSH). sh [..., (deg+1)², 3], dirs [..., 3]. Returns
    (rgb [..., 3], clamped mask [..., 3])."""
    dirn = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-8)
    x, y, z = dirn[..., 0:1], dirn[..., 1:2], dirn[..., 2:3]
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        result = (result - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :]
                  - SH_C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4, :]
                      + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :]
                      + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + SH_C3[1] * xy * z * sh[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    result = result + 0.5
    return torch.clamp(result, min=0.0), result < 0.0


def ndc2pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] → continuous pixel coordinate (auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5


class ProjectedGaussians(NamedTuple):
    """Output of `preprocess`, all [..., N, ·]."""
    means2d: torch.Tensor       # [..., N, 2] pixel-space centers
    depths: torch.Tensor        # [..., N] view-space z
    conic: torch.Tensor         # [..., N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor       # [..., N]
    radii: torch.Tensor         # [..., N] int32 3σ radius (0 = culled)
    rgb: torch.Tensor           # [..., N, 3]
    rect_min: torch.Tensor      # [..., N, 2] int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor      # [..., N, 2] int32 tile rect, exclusive
    valid: torch.Tensor         # [..., N] bool
    tiles_touched: torch.Tensor  # [..., N] int32 rect area (0 if culled)


def get_rect(point_image: torch.Tensor, radius: torch.Tensor, tiles_x: int,
             tiles_y: int, tile: int):
    """Tile-rect bounds of a splat (auxiliary.h:46-56); int32 truncation as
    `astype(int32)` (toward zero), then the clip."""
    def bound(v, hi):
        return torch.clamp((v / tile).to(torch.int32), 0, hi)

    px, py = point_image[..., 0], point_image[..., 1]
    rmin = torch.stack([bound(px - radius, tiles_x), bound(py - radius, tiles_y)], -1)
    rmax = torch.stack([bound(px + radius + tile - 1, tiles_x),
                        bound(py + radius + tile - 1, tiles_y)], -1)
    return rmin, rmax


def preprocess(means3d: torch.Tensor, opacities: torch.Tensor, camera,
               width: int, height: int, tile: int,
               scales: Optional[torch.Tensor] = None,
               rotations: Optional[torch.Tensor] = None,
               shs: Optional[torch.Tensor] = None,
               sh_degree: int = 1,
               scale_modifier: float = 1.0) -> ProjectedGaussians:
    """Vectorized preprocessCUDA (forward.cu:155-257). means3d [..., N, 3];
    `camera` a Camera whose fields carry the same leading dims."""
    tiles_x = (width + tile - 1) // tile
    tiles_y = (height + tile - 1) // tile
    hom = torch.cat([means3d, torch.ones_like(means3d[..., :1])], dim=-1)
    p_view = torch.matmul(hom, camera.world_view_transform[..., :, :3])
    p_hom = torch.matmul(hom, camera.full_proj_transform)
    in_front = p_view[..., 2] > NEAR_CULL_Z
    hom_w_safe = torch.where(in_front, p_hom[..., 3], torch.ones_like(p_hom[..., 3]))
    p_w = 1.0 / (hom_w_safe + HOM_EPS)
    p_proj = p_hom[..., :3] * p_w[..., None]

    cov3d6 = build_cov3d(scales, rotations, scale_modifier)
    focal_x = width / (2.0 * camera.tan_fovx)
    focal_y = height / (2.0 * camera.tan_fovy)
    safe = constant((0.0, 0.0, 1.0), p_view.dtype, p_view.device)
    p_view_safe = torch.where(in_front[..., None], p_view, safe)
    cov2d = project_cov2d(p_view_safe, cov3d6,
                          camera.world_view_transform[..., :3, :3].transpose(-1, -2),
                          focal_x, focal_y, camera.tan_fovx, camera.tan_fovy)

    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv,
                         cov2d[..., 0] * det_inv], dim=-1)

    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=EIG_FLOOR))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))

    point_image = torch.stack([ndc2pix(p_proj[..., 0], width),
                               ndc2pix(p_proj[..., 1], height)], dim=-1)
    rect_min, rect_max = get_rect(point_image, radius_f, tiles_x, tiles_y, tile)
    rect_area = ((rect_max[..., 0] - rect_min[..., 0])
                 * (rect_max[..., 1] - rect_min[..., 1]))
    valid = in_front & det_ok & (rect_area > 0)

    view_dirs = means3d - camera.camera_center[..., None, :]
    rgb, _ = eval_sh(shs, sh_degree, view_dirs)
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    tiles_touched = torch.where(valid, rect_area, torch.zeros_like(rect_area))
    return ProjectedGaussians(
        means2d=point_image, depths=p_view[..., 2], conic=conic,
        opacity=opacities.reshape(means3d.shape[:-1]), radii=radii, rgb=rgb,
        rect_min=rect_min, rect_max=rect_max, valid=valid,
        tiles_touched=tiles_touched.to(torch.int32))
