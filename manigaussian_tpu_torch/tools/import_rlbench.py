"""Importer for the reference's actual on-disk demo format (port of
`manigaussian_tpu/tools/import_rlbench.py`, on this package's
`data/episode.py`; Pillow is imported where a PNG is read or written).

The reference stores each episode as (rlbench/backend/const.py:23-36,
rlbench/utils.py:78-231):

    <task>/all_variations/episodes/episode<k>/
        low_dim_obs.pkl              pickled rlbench `Demo` of `Observation`s
        variation_descriptions.pkl   pickled list[str]
        variation_number.pkl         pickled int
        front_rgb/<t>.png            uint8 RGB
        front_depth/<t>.png          24-bit fixed-point depth packed into RGB
                                     (rlbench/backend/utils.py:168-207,
                                     DEPTH_SCALE = 2**24-1); metric depth =
                                     near + d*(far-near) with near/far from
                                     Observation.misc['front_camera_{near,far}']
                                     (utils.py:320-328)
        nerf_data/<t>/{images,depths,poses}/   (identical to our native layout)

This module converts that layout into the native one (data/episode.py:
low_dim_obs.npz + float32 .npy depth) WITHOUT an rlbench dependency: the
pickle is read through a whitelisting Unpickler that maps the rlbench/Demo/
Observation globals onto attribute-bag shims and refuses everything else
(stored demos are data, not code — never blindly unpickle).

Usage:
    python -m manigaussian_tpu_torch.tools.import_rlbench \
        --src /data/rlbench_demos --dst /data/native_demos \
        --tasks open_drawer turn_tap [--episodes 20]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
from typing import Dict, List

import numpy as np

from manigaussian_tpu_torch.data import episode as ep

DEPTH_SCALE = 2 ** 24 - 1  # rlbench/backend/const.py:40

# pickled globals we allow, mapped to local shims; every Observation/Demo
# attribute arrives through __dict__ (neither class customizes pickling)
_ALLOWED_SHIMS = {
    ("rlbench.demo", "Demo"),
    ("rlbench.backend.observation", "Observation"),
}
_ALLOWED_NUMPY = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


class _Shim:
    """Attribute bag standing in for rlbench Demo/Observation instances."""


class _RLBenchUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED_SHIMS:
            return _Shim
        if (module, name) in _ALLOWED_NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle global {module}.{name} — stored demos "
            "should only contain rlbench Demo/Observation + numpy data")


def load_demo_pickle(path: str) -> List[_Shim]:
    """low_dim_obs.pkl → list of per-step observation shims."""
    with open(path, "rb") as f:
        demo = _RLBenchUnpickler(f).load()
    # Demo keeps its steps in _observations (rlbench/demo.py:6-15); a bare
    # list (some exporters) is accepted too
    obs = getattr(demo, "_observations", demo)
    return list(obs)


def decode_depth_png(path: str, near: float, far: float) -> np.ndarray:
    """RGB-packed fixed-point depth PNG → float32 metric depth.

    image_to_float_array (rlbench/backend/utils.py:168-207): 24-bit integer
    R*65536+G*256+B scaled by 1/DEPTH_SCALE, then near/far rescale
    (rlbench/utils.py:320-328).
    """
    from PIL import Image
    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        d = arr[..., :3].astype(np.float64) @ np.array([65536.0, 256.0, 1.0])
    else:  # grayscale fallback: dtype max is the scale
        d = arr.astype(np.float64) * (DEPTH_SCALE / np.iinfo(arr.dtype).max)
    d /= DEPTH_SCALE
    return (near + d * (far - near)).astype(np.float32)


def encode_depth_png(depth_01: np.ndarray):
    """Inverse of decode (FloatArrayToRgbImage parity) — fixture/export helper."""
    from PIL import Image
    v = np.clip(np.round(depth_01.astype(np.float64) * DEPTH_SCALE), 0,
                DEPTH_SCALE).astype(np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8)
    return Image.fromarray(rgb, mode="RGB")


def import_episode(src_ep: str, dst_root: str, task: str, index: int,
                   cameras=("front",)) -> str:
    """Convert one reference episode directory to the native layout."""
    from PIL import Image
    obs = load_demo_pickle(os.path.join(src_ep, "low_dim_obs.pkl"))
    t_steps = len(obs)

    desc_pkl = os.path.join(src_ep, "variation_descriptions.pkl")
    if os.path.exists(desc_pkl):
        with open(desc_pkl, "rb") as f:
            descriptions = list(_RLBenchUnpickler(f).load())
    else:
        descriptions = ["unknown task description"]  # utils.py:94-96

    rgb: Dict[str, np.ndarray] = {}
    depth: Dict[str, np.ndarray] = {}
    extr: Dict[str, np.ndarray] = {}
    intr: Dict[str, np.ndarray] = {}
    for cam in cameras:
        frames_rgb, frames_d, ext, K = [], [], [], []
        for t in range(t_steps):
            m = obs[t].misc
            frames_rgb.append(np.asarray(Image.open(
                os.path.join(src_ep, f"{cam}_rgb", f"{t}.png")).convert(
                    "RGB")))
            frames_d.append(decode_depth_png(
                os.path.join(src_ep, f"{cam}_depth", f"{t}.png"),
                float(m[f"{cam}_camera_near"]), float(m[f"{cam}_camera_far"])))
            ext.append(np.asarray(m[f"{cam}_camera_extrinsics"], np.float32))
            K.append(np.asarray(m[f"{cam}_camera_intrinsics"], np.float32))
        rgb[cam] = np.stack(frames_rgb)
        depth[cam] = np.stack(frames_d)
        extr[cam] = np.stack(ext)
        intr[cam] = np.stack(K)

    low_dim = dict(
        gripper_open=np.array([float(o.gripper_open) for o in obs],
                              np.float32),
        gripper_pose=np.stack([np.asarray(o.gripper_pose, np.float32)
                               for o in obs]),
        gripper_joint_positions=np.stack(
            [np.asarray(o.gripper_joint_positions, np.float32) for o in obs]),
        joint_velocities=np.stack([np.asarray(o.joint_velocities, np.float32)
                                   for o in obs]),
        ignore_collisions=np.array(
            [float(np.asarray(getattr(o, "ignore_collisions", 0.0)).item())
             for o in obs], np.float32),
    )

    out = ep.write_episode(dst_root, task, index, rgb=rgb, depth=depth,
                           low_dim=low_dim, camera_extrinsics=extr,
                           camera_intrinsics=intr, descriptions=descriptions)

    # nerf_data is byte-identical between the two layouts
    # (NeRFTaskRecorder.save, yarr/utils/video_utils.py:219-278) — copy as-is
    src_nerf = os.path.join(src_ep, ep.NERF_FOLDER)
    if os.path.isdir(src_nerf):
        dst_nerf = os.path.join(out, ep.NERF_FOLDER)
        shutil.rmtree(dst_nerf, ignore_errors=True)
        shutil.copytree(src_nerf, dst_nerf)
    return out


def import_task(src_root: str, dst_root: str, task: str,
                episodes: int = -1, cameras=("front",)) -> int:
    src_eps = os.path.join(src_root, task, ep.VARIATIONS_ALL_FOLDER,
                           ep.EPISODES_FOLDER)
    if not os.path.isdir(src_eps):
        raise FileNotFoundError(f"no reference episodes under {src_eps}")
    names = sorted((n for n in os.listdir(src_eps) if n.startswith("episode")),
                   key=lambda s: int(s[7:]))
    if episodes > 0:
        names = names[:episodes]
    for name in names:
        import_episode(os.path.join(src_eps, name), dst_root, task,
                       int(name[7:]), cameras=cameras)
    return len(names)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="reference dataset root (RLBench layout)")
    parser.add_argument("--dst", required=True, help="native dataset root")
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--episodes", type=int, default=-1)
    parser.add_argument("--cameras", nargs="+", default=["front"])
    args = parser.parse_args(argv)
    summary = {}
    for task in args.tasks:
        n = import_task(args.src, args.dst, task, args.episodes,
                        cameras=tuple(args.cameras))
        summary[task] = n
        print(f"[import] {task}: {n} episodes")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
