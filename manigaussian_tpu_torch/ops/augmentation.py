"""SE(3) scene/action augmentation for behavior cloning (port of
`manigaussian_tpu/ops/augmentation.py:50-148`; reference
`voxel/augmentation.py:133-416`).

A bounded random translation and a discretized euler rotation about the
keyframe gripper position; the perturbed action is re-discretized, and of
K = 10 pre-sampled attempts per batch element the first whose voxel index
stays in the grid is taken (else the unperturbed data). The random draws are
split from their application: `sample_se3_draws` takes them from an explicit
generator, and `apply_se3_augmentation` takes them as tensors, so a test can
feed it the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from manigaussian_tpu_torch.ops import rotation as rot

MAX_ATTEMPTS = 10


class SE3Draws(NamedTuple):
    trans_unit: torch.Tensor   # [K, B, 3] uniform in [-1, 1)
    rot_steps: torch.Tensor    # [K, B, 3] int in [-steps, steps]


class AugmentOutput(NamedTuple):
    action_trans: torch.Tensor       # [B, 3] int32 voxel indices
    action_rot_grip: torch.Tensor    # [B, 4] int32 (euler bins ×3, grip)
    pcd: torch.Tensor                # [B, ..., 3] perturbed points
    camera_pose: Optional[torch.Tensor]  # [B, n_cam, 4, 4] perturbed c2w


def _rot_steps(rot_aug_range, rot_aug_resolution) -> list:
    return [int(r // rot_aug_resolution) for r in rot_aug_range]


def sample_se3_draws(generator: torch.Generator, batch: int,
                     rot_aug_range=(0.0, 0.0, 45.0),
                     rot_aug_resolution: float = 5.0) -> SE3Draws:
    """The K attempts' random numbers (on the CPU): the JAX function's
    `jax.random.uniform(-1, 1)` and `jax.random.randint(-steps, steps+1)`."""
    u = torch.rand(MAX_ATTEMPTS, batch, 3, generator=generator) * 2.0 - 1.0
    steps = torch.tensor(_rot_steps(rot_aug_range, rot_aug_resolution))
    r = torch.rand(MAX_ATTEMPTS, batch, 3, generator=generator)
    rot_steps = torch.floor(r * (2 * steps + 1)).long() - steps
    return SE3Draws(u, rot_steps.to(torch.int32))


def _unclamped_voxel_index(point, bounds, voxel_size: int):
    """floor index, top-clamped only: negatives stay negative so that an
    out-of-bounds perturbation shows. Divisions by tensors (true divisions,
    as in JAX)."""
    bb_min = bounds[..., :3]
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=point.device)
    res = (bounds[..., 3:] - bb_min) / c(voxel_size + 1e-12)
    idx = torch.floor((point - bb_min) / (res + c(1e-12))).to(torch.int32)
    return torch.clamp(idx, max=voxel_size - 1)


def apply_se3_augmentation(draws: SE3Draws, pcd: torch.Tensor,
                           action_gripper_pose: torch.Tensor,
                           action_trans: torch.Tensor,
                           action_rot_grip: torch.Tensor,
                           bounds: torch.Tensor,
                           trans_aug_range=(0.125, 0.125, 0.125),
                           rot_aug_resolution: float = 5.0,
                           voxel_size: int = 100,
                           rot_resolution: float = 5.0,
                           camera_pose: Optional[torch.Tensor] = None
                           ) -> AugmentOutput:
    """pcd [B, ..., 3] world points, action_gripper_pose [B, 7] (xyz + quat
    xyzw), action_trans [B, 3] and action_rot_grip [B, 4] int, bounds [6] or
    [B, 6]; `draws` from `sample_se3_draws` (or the JAX package's)."""
    dev = pcd.device
    b = action_gripper_pose.shape[0]
    bounds = bounds.to(torch.float32).reshape(-1, 6).expand(b, 6)
    trans_range = (bounds[:, 3:] - bounds[:, :3]) * torch.tensor(
        trans_aug_range, dtype=torch.float32, device=dev)          # [B, 3]
    trans_shift = trans_range[None] * draws.trans_unit.to(dev)     # [K, B, 3]
    euler = draws.rot_steps.to(dev).float() * torch.tensor(
        math.radians(rot_aug_resolution), dtype=torch.float32, device=dev)
    rot_shift = rot.euler_to_matrix(euler, "XYZ")                  # [K, B, 3, 3]

    grip_rot = rot.quat_wxyz_to_matrix(
        rot.quat_xyzw_to_wxyz(action_gripper_pose[:, 3:7]))
    grip_t = action_gripper_pose[:, :3]
    pert_rot = torch.matmul(grip_rot[None], rot_shift)             # R_a @ R_s
    pert_t = grip_t[None] + trans_shift
    trans_idx = _unclamped_voxel_index(pert_t, bounds[None], voxel_size)
    valid = (trans_idx >= 0).all(dim=-1)                           # [K, B]
    first = torch.argmax(valid.to(torch.int32), dim=0)             # first valid
    any_valid = valid.any(dim=0)
    cols = torch.arange(b, device=dev)
    pick = lambda x: x[first, cols]

    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    sel_rot = torch.where(any_valid[:, None, None], pick(rot_shift), eye)
    sel_shift = torch.where(any_valid[:, None], pick(trans_shift),
                            torch.zeros_like(grip_t))
    quat_xyzw = rot.quat_wxyz_to_xyzw(rot.matrix_to_quat_wxyz(pick(pert_rot)))
    quat_xyzw = torch.where(quat_xyzw[:, 3:4] < 0, -quat_xyzw, quat_xyzw)
    rot_bins = rot.quaternion_to_discrete_euler(quat_xyzw, rot_resolution)

    new_trans = torch.where(any_valid[:, None], pick(trans_idx),
                            action_trans.to(torch.int32))
    new_rot_grip = torch.cat(
        [torch.where(any_valid[:, None], rot_bins,
                     action_rot_grip[:, :3].to(torch.int32)),
         action_rot_grip[:, 3:4].to(torch.int32)], dim=-1)

    lo = bounds[:, :3].amin(dim=0)
    hi = bounds[:, 3:].amax(dim=0)
    new_origin = torch.minimum(torch.maximum(grip_t + sel_shift, lo), hi)

    # x' = R_sᵀ (x - t_a) + new_origin (the reference's row-vector bmm)
    flat = pcd.reshape(b, -1, 3)
    new_pcd = (torch.matmul(flat - grip_t[:, None, :], sel_rot)
               + new_origin[:, None, :]).reshape(pcd.shape)

    new_cam = None
    if camera_pose is not None:
        cam_t = camera_pose[..., :3, 3]
        new_cam = camera_pose.clone()
        new_cam[..., :3, 3] = (torch.matmul(cam_t - grip_t[:, None], sel_rot)
                               + new_origin[:, None])
        new_cam[..., :3, :3] = torch.matmul(sel_rot.transpose(-1, -2)[:, None],
                                            camera_pose[..., :3, :3])
    return AugmentOutput(new_trans, new_rot_grip, new_pcd, new_cam)
