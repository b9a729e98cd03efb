"""Rotation conversions and the discrete-euler action codec.

Port of `manigaussian_tpu/ops/rotation.py` (reference `helpers/utils.py:50-79`,
pytorch3d `euler_angles_to_matrix` / `matrix_to_quaternion`). Quaternions:
`_wxyz` = scalar-first, `_xyzw` = scalar-last (RLBench gripper poses).
Branch-free and batched over leading dims, like the JAX functions.
"""

from __future__ import annotations

import math

import torch

from manigaussian_tpu_torch.ops.gaussian_math import \
    quat_to_rotmat as quat_wxyz_to_matrix


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def _axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == "Y":
        rows = [c, z, s, z, o, z, -s, z, c]
    else:
        rows = [c, -s, z, s, c, z, z, z, o]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """pytorch3d-compatible: R = R_c0(e0) @ R_c1(e1) @ R_c2(e2) (intrinsic)."""
    rot = _axis_rot(convention[0], euler[..., 0])
    for i in (1, 2):
        rot = torch.matmul(rot, _axis_rot(convention[i], euler[..., i]))
    return rot


def matrix_to_quat_wxyz(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (w, x, y, z): all four candidate
    forms, the one keyed to the largest of (trace, R00, R11, R22) chosen
    with `where` (no data-dependent control flow)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack([s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1) * 0.5
    s1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1) * 0.5
    s2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2,
                      (m12 + m21) / s2], dim=-1) * 0.5
    s3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                      (m12 + m21) / s3, s3], dim=-1) * 0.5

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    return normalize_quaternion(q)


def matrix_to_euler_xyz_extrinsic(rot: torch.Tensor) -> torch.Tensor:
    """(a, b, c) with R = Rz(c) @ Ry(b) @ Rx(a) — scipy's 'xyz' (extrinsic)."""
    b = torch.arcsin(torch.clamp(-rot[..., 2, 0], -1.0, 1.0))
    a = torch.arctan2(rot[..., 2, 1], rot[..., 2, 2])
    c = torch.arctan2(rot[..., 1, 0], rot[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def euler_xyz_extrinsic_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """R = Rz(e2) @ Ry(e1) @ Rx(e0) (scipy 'xyz' extrinsic)."""
    return torch.matmul(_axis_rot("Z", euler[..., 2]),
                        torch.matmul(_axis_rot("Y", euler[..., 1]),
                                     _axis_rot("X", euler[..., 0])))


def quaternion_to_discrete_euler(quat_xyzw: torch.Tensor,
                                 resolution: float) -> torch.Tensor:
    """Quaternion → discretized euler bin indices in [0, 360/res)
    (scipy as_euler('xyz', degrees=True) + 180, rounded, 360 wraps to 0)."""
    rot = quat_wxyz_to_matrix(quat_xyzw_to_wxyz(normalize_quaternion(quat_xyzw)))
    euler_deg = torch.rad2deg(matrix_to_euler_xyz_extrinsic(rot)) + 180.0
    disc = torch.round(euler_deg / resolution).to(torch.int32)
    nbins = int(360 / resolution)
    return torch.where(disc == nbins, torch.zeros_like(disc), disc)


def discrete_euler_to_quaternion(disc: torch.Tensor,
                                 resolution: float) -> torch.Tensor:
    """Inverse codec → quaternion xyzw (helpers/utils.py:76-78)."""
    deg = disc.to(torch.float32) * resolution - 180.0
    euler = deg * torch.tensor(math.pi / 180.0, dtype=torch.float32,
                               device=deg.device)
    rot = euler_xyz_extrinsic_to_matrix(euler)
    return quat_wxyz_to_xyzw(matrix_to_quat_wxyz(rot))
