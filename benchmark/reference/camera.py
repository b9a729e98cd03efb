"""Camera math for the Gaussian-splat renderer (port of
`manigaussian_tpu/ops/camera.py`).

Parity with the reference `graphics_utils.py:17-78` (getWorld2View2 /
getProjectionMatrix / focal2fov / depth2pc) and `get_novel_calib`
(neural_rendering.py:205-248). Every function takes leading batch dims, so
the JAX package's `novel_camera_calib_batch` (a vmap) is
`novel_camera_calib` on batched inputs here.

Conventions (those of the reference CUDA rasterizer, which consumes
transposed matrices): `world_view_transform` Vt is the transpose of the
world→camera matrix V (row vectors: p_view = [p, 1] @ Vt);
`full_proj_transform` = Vt @ Pt; `camera_center` is the camera origin in
world coordinates. Products are full fp32: the JAX `_mm` asks for
Precision.HIGHEST, which on the card is PyTorch's default
(torch.backends.cuda.matmul.allow_tf32 = False).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Camera(NamedTuple):
    """Per-view camera state consumed by the rasterizer ([..., ·] batched)."""
    world_view_transform: torch.Tensor  # [..., 4, 4] transposed world→cam
    full_proj_transform: torch.Tensor   # [..., 4, 4] transposed world→clip
    camera_center: torch.Tensor         # [..., 3]
    tan_fovx: torch.Tensor              # [...]
    tan_fovy: torch.Tensor              # [...]


def focal2fov(focal, pixels):
    """Full field-of-view angle from focal length (graphics_utils.py:51)."""
    return 2.0 * torch.arctan(pixels / (2.0 * focal))


def world_to_view(rot: torch.Tensor, t: torch.Tensor,
                  translate: Optional[torch.Tensor] = None,
                  scale: float = 1.0) -> torch.Tensor:
    """World→camera 4x4 (not transposed). `rot` is the CAMERA→WORLD rotation
    (the reference passes `extr_w2c[:3,:3].T`), `t` the world→camera
    translation; `translate`/`scale` shift and scale the camera center."""
    rt = rot.transpose(-1, -2)
    center = -torch.matmul(rot, t[..., None])[..., 0]
    if translate is not None:
        center = center + translate
    center = center * scale
    v = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    v[..., :3, :3] = rt
    v[..., :3, 3] = -torch.matmul(rt, center[..., None])[..., 0]
    v[..., 3, 3] = 1.0
    return v


def projection_from_intrinsics(k: torch.Tensor, znear: float, zfar: float,
                               h: int, w: int) -> torch.Tensor:
    """OpenGL-style perspective projection from a pixel intrinsic matrix
    (getProjectionMatrix, off-center principal points); not transposed."""
    fx, fy = k[..., 0, 0], k[..., 1, 1]
    cx, cy = k[..., 0, 2], k[..., 1, 2]
    near_fx = znear / fx
    near_fy = znear / fy
    left = -(w - cx) * near_fx
    right = cx * near_fx
    bottom = (cy - h) * near_fy
    top = cy * near_fy
    p = torch.zeros(k.shape[:-2] + (4, 4), dtype=k.dtype, device=k.device)
    p[..., 0, 0] = 2.0 * znear / (right - left)
    p[..., 1, 1] = 2.0 * znear / (top - bottom)
    p[..., 0, 2] = (right + left) / (right - left)
    p[..., 1, 2] = (top + bottom) / (top - bottom)
    p[..., 3, 2] = 1.0
    p[..., 2, 2] = zfar / (zfar - znear)
    p[..., 2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def novel_camera_calib(intrinsic: torch.Tensor, extrinsic_c2w: torch.Tensor,
                       znear: float, zfar: float, h: int, w: int,
                       translate: Optional[torch.Tensor] = None,
                       scale: float = 1.0) -> Camera:
    """The rasterizer's Camera from cam→world extrinsics [..., 4, 4] and pixel
    intrinsics [..., 3, 3]."""
    extr = torch.linalg.inv(extrinsic_c2w)           # world→cam
    rot = extr[..., :3, :3].transpose(-1, -2)        # cam→world rotation
    v = world_to_view(rot, extr[..., :3, 3], translate=translate, scale=scale)
    p = projection_from_intrinsics(intrinsic, znear, zfar, h, w)
    vt = v.transpose(-1, -2)
    full_proj = torch.matmul(vt, p.transpose(-1, -2))
    center = torch.linalg.inv(vt)[..., 3, :3]
    tan_fovx = torch.tan(focal2fov(intrinsic[..., 0, 0], w) * 0.5)
    tan_fovy = torch.tan(focal2fov(intrinsic[..., 1, 1], h) * 0.5)
    return Camera(vt, full_proj, center, tan_fovx, tan_fovy)


def depth_to_pointcloud(depth: torch.Tensor, extrinsic_w2c: torch.Tensor,
                        intrinsic: torch.Tensor) -> torch.Tensor:
    """depth [H, W], extrinsic_w2c [4, 4], intrinsic [3, 3] → [H*W, 3]
    world points (depth2pc: pixel centers at +0.5, z-depth)."""
    h, w = depth.shape
    kw = dict(dtype=torch.float32, device=depth.device)
    y = torch.linspace(0.5, h - 0.5, h, **kw)
    x = torch.linspace(0.5, w - 0.5, w, **kw)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    z = depth
    px = (xx - cx) * z / fx
    py = (yy - cy) * z / fy
    pts_cam = torch.stack([px, py, z], dim=-1).reshape(-1, 3)
    rot = extrinsic_w2c[:3, :3]
    t = extrinsic_w2c[:3, 3]
    # R.T @ (p - t) in row-vector form
    return torch.matmul(pts_cam - t, rot)


def world_to_canonical(xyz: torch.Tensor, bounds) -> torch.Tensor:
    """World xyz → [0,1]^3 of the workspace box [xmin, ymin, zmin, xmax,
    ymax, zmax] (models_embed.py:147-165), by true divisions."""
    b = torch.as_tensor(bounds, dtype=xyz.dtype, device=xyz.device)
    return (xyz - b[:3]) / (b[3:] - b[:3])
