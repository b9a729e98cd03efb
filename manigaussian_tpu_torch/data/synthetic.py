"""Synthetic stored-demo fixture generator (no CoppeliaSim dependency).

A copy of `manigaussian_tpu/data/synthetic.py`: the same seed writes the
same episodes (tests/test_torch_act_eval.py compares the files).

Builds fake-but-well-formed task datasets in the exact on-disk episode format
(data/episode.py) so the entire train stack — replay fill, keypoint discovery,
nerf-view sampling, camera parsing, voxelization — runs in CI and benchmarks.
Replaces the reference's RLBench demo generation
(`tools/nerf_dataset_generator.py` + `NeRFTaskRecorder`, SURVEY.md §3.4) for
testing purposes.

Round-5 upgrade: every image (front camera AND nerf views) is ray-cast from
ONE consistent 3D scene — a checkered table plane plus spheres — instead of
pixel noise, so all three world-model losses have real signal:
  * RGB reconstruction: novel views share geometry with the input view, so
    rendered-view PSNR can genuinely improve during training;
  * dynamics: a "gripper" sphere moves smoothly along the demo trajectory, so
    the next-frame target differs from the current frame by real scene motion
    conditioned on the action;
  * policy: the "object" sphere sits at the NEXT keyframe's gripper position
    and its color encodes that keyframe's gripper bit (white=open, red=close)
    — unprojecting its pixels reconstructs the BC translation target, and the
    color is the only source of the grip label for start-augmented
    transitions (R4 learning diagnostic, scripts/diagnose_learning.py);
  * adversarial robustness: per-episode DISTRACTOR spheres at off-target
    positions with non-signal colors, so a policy that merely finds "any
    bright blob" fails held-out eval.
"""

from __future__ import annotations

import numpy as np

from manigaussian_tpu_torch.data import episode as ep

SCENE_BOUNDS = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)

# distractor palette — intentionally excludes white/red (the grip-bit colors)
DISTRACTOR_COLORS = np.array([
    [60, 220, 80],    # green
    [255, 160, 40],   # orange
    [60, 210, 220],   # cyan
    [220, 60, 220],   # magenta
], np.float32)

_GRIPPER_COLOR = np.array([70, 110, 255], np.float32)   # blue
_OPEN_COLOR = np.array([255, 255, 255], np.float32)     # white = open
_CLOSE_COLOR = np.array([255, 40, 40], np.float32)      # red = close
_BG_COLOR = np.array([15, 15, 20], np.float32)
_BG_DEPTH = 3.5            # inside znear/zfar (0.1/4.0), outside scene bounds
_PLANE_Z = 0.75
_LIGHT = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])

# per-camera eye offsets from the scene center (RLBench's five-camera rig,
# rlbench/observation_config.py:59-77; poses chosen to keep _look_at
# non-degenerate). Unknown camera names fall back to the front viewpoint.
_CAMERA_EYES = {
    "front": (0.0, -0.8, 0.5),
    "overhead": (0.25, 0.05, 0.95),
    "left_shoulder": (-0.55, 0.5, 0.45),
    "right_shoulder": (-0.55, -0.5, 0.45),
    "wrist": (0.4, 0.1, 0.3),
}


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """c2w pose with +z forward (OpenCV convention, matches RLBench cameras)."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w.astype(np.float32)


def _intrinsics(h, w, focal):
    return np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]],
                    np.float32)


def render_scene(c2w, intr, h, w, spheres, plane_z=_PLANE_Z, rng=None,
                 noise=2.0):
    """Ray-cast one view of a sphere/plane scene.

    Pixel centers at +0.5 and z-depth convention exactly match
    ops/camera.depth_to_pointcloud (graphics_utils.py:56-78 parity), so
    unprojecting the returned depth reconstructs the scene geometry bit-true.

    spheres: sequence of (center [3], radius, color [3] in 0..255).
    Returns (rgb uint8 [h,w,3], depth float32 [h,w] z-depth).
    """
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    yy, xx = np.meshgrid(np.linspace(0.5, h - 0.5, h),
                         np.linspace(0.5, w - 0.5, w), indexing="ij")
    # camera-frame ray directions with unit z: depth along the ray IS z-depth
    v = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                 -1).reshape(-1, 3)
    eye = c2w[:3, 3].astype(np.float64)
    d = v @ c2w[:3, :3].T.astype(np.float64)                  # world dirs [P,3]

    depth = np.full(h * w, np.inf)
    color = np.tile(_BG_COLOR, (h * w, 1))

    # table plane z = plane_z (checkerboard in world x/y)
    denom = d[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (plane_z - eye[2]) / denom
    p = eye + s[:, None] * d
    # clamp the table to the workspace footprint — grazing rays otherwise hit
    # the plane at horizon distances far outside the scene bounds
    hit = ((np.abs(denom) > 1e-9) & (s > 0.05) & (s < depth)
           & (np.abs(p[:, 0] - 0.2) <= 0.55) & (np.abs(p[:, 1]) <= 0.55))
    if hit.any():
        checker = ((np.floor(p[hit, 0] / 0.1) + np.floor(p[hit, 1] / 0.1))
                   % 2).astype(bool)
        depth[hit] = s[hit]
        color[hit] = np.where(checker[:, None], 95.0, 140.0) * np.ones((1, 3))

    for center, radius, col in spheres:
        center = np.asarray(center, np.float64)
        oc = eye - center
        A = np.sum(d * d, -1)
        B = 2.0 * d @ oc
        C = oc @ oc - radius * radius
        disc = B * B - 4 * A * C
        ok = disc > 0
        s = np.full(h * w, np.inf)
        s[ok] = (-B[ok] - np.sqrt(disc[ok])) / (2 * A[ok])
        hit = ok & (s > 0.05) & (s < depth)
        if hit.any():
            p = eye + s[hit, None] * d[hit]
            n = (p - center) / radius
            shade = 0.55 + 0.45 * np.clip(n @ _LIGHT, 0.0, 1.0)
            depth[hit] = s[hit]
            color[hit] = np.asarray(col, np.float32) * shade[:, None]

    depth[~np.isfinite(depth)] = _BG_DEPTH
    if rng is not None and noise > 0:
        color = color + rng.normal(0.0, noise, color.shape)
    rgb = np.clip(color, 0, 255).astype(np.uint8).reshape(h, w, 3)
    return rgb, depth.astype(np.float32).reshape(h, w)


def _scene_spheres(pos, gripper_open, kps, t, distractors):
    """Scene state at timestep t: object sphere at the NEXT keyframe target
    (color = that keyframe's grip bit), gripper sphere at the current gripper
    position, plus the episode's fixed distractors."""
    nxt = [k for k in kps if k > t]
    kp = nxt[0] if nxt else (kps[-1] if kps else len(pos) - 1)
    obj_color = _OPEN_COLOR if gripper_open[kp] > 0.5 else _CLOSE_COLOR
    spheres = [(pos[kp], 0.05, obj_color), (pos[t], 0.035, _GRIPPER_COLOR)]
    spheres.extend(distractors)
    return spheres


def _make_distractors(rng, keyframe_positions, n):
    """Fixed per-episode distractor spheres, rejected away from every keyframe
    target so they can't be mistaken for the object."""
    out = []
    lo = np.array([-0.15, -0.35, 0.85])
    hi = np.array([0.55, 0.35, 1.35])
    tries = 0
    while len(out) < n and tries < 200:
        tries += 1
        c = rng.uniform(lo, hi)
        if keyframe_positions.size and (
                np.linalg.norm(keyframe_positions - c, axis=-1).min() < 0.12):
            continue
        col = DISTRACTOR_COLORS[rng.integers(len(DISTRACTOR_COLORS))]
        out.append((c.astype(np.float32), float(rng.uniform(0.03, 0.05)), col))
    return out


def generate_task(root: str, task: str, num_episodes: int = 2,
                  timesteps: int = 24, h: int = 32, w: int = 32,
                  nerf_views: int = 5, nerf_hw: int = 32,
                  seed: int = 0, cameras=("front",),
                  num_distractors: int = 3, noise: float = 2.0) -> None:
    rng = np.random.default_rng(seed)
    center = np.array([0.2, 0.0, 1.1], np.float32)

    for e in range(num_episodes):
        # gripper trajectory: start → grasp (close) → lift (open at end);
        # per-episode phase shift makes held-out episodes genuinely unseen
        t_axis = np.linspace(0, 1, timesteps)
        pos = center + np.stack([
            0.2 * np.cos(2 * np.pi * t_axis * 0.25 + e),
            0.2 * np.sin(2 * np.pi * t_axis * 0.25 + e),
            0.1 * t_axis], -1).astype(np.float32)
        quat = np.tile(np.array([0, 0, 0, 1.0], np.float32), (timesteps, 1))
        gripper_pose = np.concatenate([pos, quat], -1)
        gripper_open = np.ones(timesteps, np.float32)
        gripper_open[timesteps // 3: 2 * timesteps // 3] = 0.0
        joint_vel = rng.normal(0, 1.0, (timesteps, 7)).astype(np.float32)
        joint_vel[timesteps // 2] = 0.0  # one stopped keyframe
        grip_joints = np.tile(np.array([0.02, 0.02], np.float32), (timesteps, 1))
        ignore_coll = np.zeros(timesteps, np.float32)

        from manigaussian_tpu_torch.data.keypoints import keypoint_discovery
        kps = keypoint_discovery(gripper_open, joint_vel)
        distractors = _make_distractors(
            rng, pos[np.asarray(kps, int)] if kps else pos[:0],
            num_distractors)

        intr = _intrinsics(h, w, focal=float(w))
        cam_pose = {c: _look_at(center + np.array(
            _CAMERA_EYES.get(c, _CAMERA_EYES["front"])), center)
            for c in cameras}
        cam_rgb = {c: np.empty((timesteps, h, w, 3), np.uint8)
                   for c in cameras}
        cam_depth = {c: np.empty((timesteps, h, w), np.float32)
                     for c in cameras}
        for t in range(timesteps):
            spheres = _scene_spheres(pos, gripper_open, kps, t, distractors)
            for c in cameras:
                cam_rgb[c][t], cam_depth[c][t] = render_scene(
                    cam_pose[c], intr, h, w, spheres, rng=rng, noise=noise)

        # nerf views: ring cameras rendering the SAME scene state as frame t
        ring = []
        for vi in range(nerf_views):
            ang = 2 * np.pi * vi / nerf_views
            eye = center + np.array([0.8 * np.cos(ang), 0.8 * np.sin(ang),
                                     0.5 + 0.12 * ((vi % 3) - 1)])
            ring.append(_look_at(eye, center))
        nerf_intr = _intrinsics(nerf_hw, nerf_hw, float(nerf_hw))
        nerf = {}
        for t in range(timesteps - 1):  # last step has no nerf data (reference)
            spheres = _scene_spheres(pos, gripper_open, kps, t, distractors)
            views_rgb = np.empty((nerf_views, nerf_hw, nerf_hw, 3), np.uint8)
            views_depth = np.empty((nerf_views, nerf_hw, nerf_hw), np.float32)
            for vi in range(nerf_views):
                views_rgb[vi], views_depth[vi] = render_scene(
                    ring[vi], nerf_intr, nerf_hw, nerf_hw, spheres,
                    rng=rng, noise=noise)
            nerf[t] = (views_rgb, views_depth, np.stack(ring),
                       np.tile(nerf_intr, (nerf_views, 1, 1)))

        ep.write_episode(
            root, task, e,
            rgb=cam_rgb,
            depth=cam_depth,
            low_dim=dict(
                gripper_open=gripper_open, gripper_pose=gripper_pose,
                gripper_joint_positions=grip_joints,
                joint_velocities=joint_vel, ignore_collisions=ignore_coll),
            camera_extrinsics={c: np.tile(cam_pose[c], (timesteps, 1, 1))
                               for c in cameras},
            camera_intrinsics={c: np.tile(intr, (timesteps, 1, 1))
                               for c in cameras},
            descriptions=[f"{task.replace('_', ' ')} demo"],
            nerf_views=nerf)
