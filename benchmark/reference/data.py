"""A training step's inputs worked out from the benchmark's raw episodes, in
NumPy and plain PyTorch: the keyframe transitions (the port's
`data/pipeline.fill_replay`, `get_action`, `make_transition`), the hashed
stub language encoder (`data/language.HashedStubLanguageModel`), the front
camera's point cloud and the NeRF targets (`assemble_batch`).

An episode is the traffic generator's in-memory record (`traffic.generator`):
the low-dim arrays, the front camera's frames, depths and camera, and the
NeRF views. `match` names the transition and the views of a batch the
program's feed made, by its raw fields; `inputs` then works out every
derived field again from the episode.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .camera import depth_to_pointcloud
from .keypoints import keypoint_discovery

SENTENCE_DIM = 1024
TOKEN_DIM = 512
MAX_TOKENS = 77
REWARD_SCALE = 100.0


def _word_vec(word: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def stub_language(text: str):
    """(sentence [1024], tokens [77, 512]): per-word gaussian vectors seeded
    by the word's hash."""
    words = text.lower().split()[: MAX_TOKENS - 2]
    toks = np.zeros((MAX_TOKENS, TOKEN_DIM), np.float32)
    toks[0] = _word_vec("<sot>", TOKEN_DIM)
    for i, w in enumerate(words):
        toks[i + 1] = _word_vec(w, TOKEN_DIM)
    toks[len(words) + 1] = _word_vec("<eot>", TOKEN_DIM)
    return _word_vec("sent::" + text.lower(), SENTENCE_DIM), toks


def point_to_voxel_index(point, voxel_size, bounds):
    bb_mins = np.array(bounds[0:3])
    bb_maxs = np.array(bounds[3:])
    res = (bb_maxs - bb_mins) / (np.array([voxel_size] * 3) + 1e-12)
    return np.minimum(np.floor((point - bb_mins) / (res + 1e-12)).astype(np.int32),
                      voxel_size - 1)


def quaternion_to_discrete_euler(quat_xyzw, resolution):
    """extrinsic 'xyz' euler degrees + 180, rounded at `resolution`, 360
    wraps to 0."""
    x, y, z, w = np.asarray(quat_xyzw, np.float64) / np.linalg.norm(quat_xyzw)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    r10 = 2 * (x * y + w * z)
    r00 = 1 - 2 * (y * y + z * z)
    euler = np.degrees([np.arctan2(r21, r22), np.arcsin(np.clip(-r20, -1, 1)),
                        np.arctan2(r10, r00)]) + 180
    disc = np.around(euler / resolution).astype(np.int32)
    disc[disc == int(360 / resolution)] = 0
    return disc


def _action(ep, keypoint: int, bounds, voxel_size: int, rot_res: int):
    pose = ep["gripper_pose"][keypoint]
    quat = pose[3:7] / np.linalg.norm(pose[3:7])
    if quat[-1] < 0:
        quat = -quat
    disc_rot = quaternion_to_discrete_euler(quat, rot_res)
    trans_idx = point_to_voxel_index(pose[:3], voxel_size, bounds)
    grip = float(ep["gripper_open"][keypoint])
    ignore = int(ep["ignore_collisions"][max(0, keypoint - 1)])
    action = np.concatenate([pose, [grip]]).astype(np.float32)
    rot_grip = np.concatenate([disc_rot, [int(grip)]]).astype(np.int32)
    return (trans_idx.astype(np.int32), rot_grip,
            np.array([ignore], np.int32), action)


def transitions(episodes: List[Dict], cfg) -> List[Dict]:
    """Every keyframe transition of the episodes, in the replay's order:
    from each start i (every `demo_augmentation_every_n` steps) one per
    later keypoint, the observation moving to each keypoint in turn."""
    m, rl = cfg.method, cfg.rlbench
    out = []
    for e, ep in enumerate(episodes):
        kps_all = keypoint_discovery(ep["gripper_open"], ep["joint_velocities"],
                                     method=m.keypoint_method)
        n = len(ep["gripper_open"])
        for i in range(n - 1):
            if not m.demo_augmentation and i > 0:
                break
            if i % m.demo_augmentation_every_n != 0:
                continue
            kps = [k for k in kps_all if i < k]
            if not kps:
                break
            t = i
            for k_idx, kp in enumerate(kps):
                terminal = k_idx == len(kps) - 1
                trans, rot_grip, ignore, action = _action(
                    ep, kp, rl.scene_bounds, m.voxel_sizes[0],
                    m.rotation_resolution)
                time_v = (1.0 - (k_idx / float(rl.episode_length - 1))) * 2.0 - 1.0
                low_dim = np.array(
                    [ep["gripper_open"][t],
                     *np.clip(ep["gripper_joint_positions"][t], 0.0, 0.04),
                     time_v], np.float32)
                out.append(dict(
                    episode=e, t=t, keypoint=kp,
                    next_t=kp if not terminal else max(0, kp - 1),
                    low_dim_state=low_dim, trans_action_indicies=trans,
                    rot_grip_action_indicies=rot_grip,
                    ignore_collisions=ignore,
                    gripper_pose=ep["gripper_pose"][kp].astype(np.float32),
                    action=action, description=ep["description"]))
                t = kp
    return out


def view_subset(num_view: int, num_view_by_user: int) -> List[int]:
    """The NeRF views a batch may draw (interval subsampling)."""
    interval = max(1, num_view // min(num_view_by_user, num_view))
    return list(range(0, num_view, interval))[:num_view_by_user]


def _frame(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32) / 255.0


def match(batch: Dict, episodes: List[Dict], trans: List[Dict],
          num_view_for_nerf: int) -> Optional[Dict]:
    """The transition and the NeRF views (row 0 of `batch`) by the raw
    fields the feed loaded: the front frame, the keyframe's state, the
    target images. None when no transition has them all."""
    rgb = np.asarray(batch["rgb"])[0, 0]
    for tr in trans:
        ep = episodes[tr["episode"]]
        if not (np.array_equal(_frame(ep["front_rgb"][tr["t"]]), rgb)
                and np.array_equal(tr["low_dim_state"],
                                   np.asarray(batch["low_dim_state"])[0])
                and np.array_equal(tr["gripper_pose"],
                                   np.asarray(batch["gripper_pose"])[0])):
            continue
        if "nerf_target_rgb" not in batch:
            return dict(tr, view=None, next_view=None)
        views = view_subset(ep["nerf_rgb"].shape[1], num_view_for_nerf)

        def find(t, key):
            want = np.asarray(batch[key])[0]
            for v in views:
                if np.array_equal(_frame(ep["nerf_rgb"][t, v]), want):
                    return v
            return None

        v, v2 = find(tr["t"], "nerf_target_rgb"), find(tr["next_t"],
                                                      "nerf_next_target_rgb")
        if v is not None and v2 is not None:
            return dict(tr, view=v, next_view=v2)
    return None


def inputs(row: Dict, episodes: List[Dict], device) -> Dict[str, torch.Tensor]:
    """The step's batch (one row), every derived field worked out here."""
    ep = episodes[row["episode"]]
    t = row["t"]
    w2c = np.linalg.inv(ep["front_extrinsic"])
    pcd = depth_to_pointcloud(
        torch.from_numpy(np.asarray(ep["front_depth"][t], np.float32)),
        torch.from_numpy(w2c.astype(np.float32)),
        torch.from_numpy(np.asarray(ep["front_intrinsic"], np.float32)))
    h, w = ep["front_depth"].shape[1:3]
    sent, toks = stub_language(row["description"])
    b = dict(rgb=_frame(ep["front_rgb"][t])[None, None],
             pcd=pcd.numpy().reshape(1, 1, h, w, 3),
             low_dim_state=row["low_dim_state"][None],
             lang_goal_emb=sent[None], lang_token_embs=toks[None],
             trans_action_indicies=row["trans_action_indicies"][None],
             rot_grip_action_indicies=row["rot_grip_action_indicies"][None],
             ignore_collisions=row["ignore_collisions"][None],
             gripper_pose=row["gripper_pose"][None], action=row["action"][None])
    if row["view"] is not None:
        b.update(
            nerf_target_rgb=_frame(ep["nerf_rgb"][t, row["view"]])[None],
            nerf_target_pose=ep["nerf_pose"][row["view"]][None],
            nerf_target_intrinsic=ep["nerf_intrinsic"][None],
            nerf_next_target_rgb=_frame(
                ep["nerf_rgb"][row["next_t"], row["next_view"]])[None],
            nerf_next_target_pose=ep["nerf_pose"][row["next_view"]][None],
            nerf_next_target_intrinsic=ep["nerf_intrinsic"][None])
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in b.items()}


def observation(ep: Dict, t: int, device) -> Dict[str, torch.Tensor]:
    """An act's observation at frame t: the front RGB in [0, 1], its point
    cloud, the low-dim state (the gripper, its joints, time 1) and the
    language embeddings."""
    row = dict(episode=0, t=t, view=None, description=ep["description"],
               low_dim_state=np.array(
                   [ep["gripper_open"][t],
                    *np.clip(ep["gripper_joint_positions"][t], 0.0, 0.04), 1.0],
                   np.float32),
               trans_action_indicies=np.zeros(3, np.int32),
               rot_grip_action_indicies=np.zeros(4, np.int32),
               ignore_collisions=np.zeros(1, np.int32),
               gripper_pose=ep["gripper_pose"][t].astype(np.float32),
               action=np.zeros(8, np.float32))
    b = inputs(row, [ep], device)
    return {k: b[k] for k in ("rgb", "pcd", "low_dim_state", "lang_goal_emb",
                              "lang_token_embs")}
