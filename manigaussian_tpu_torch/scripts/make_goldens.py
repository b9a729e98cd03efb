"""Regenerate the golden-frame fixtures (counterpart of
`scripts/make_goldens.py`).

The scenes are depth-unprojected point clouds (a table plane with a sphere
on it, through `ops/camera.depth_to_pointcloud`) turned into Gaussians and
rendered from a novel camera; gradients of a fixed scalar loss are taken
through the render, and inputs, frames, final transmittance and
per-parameter gradients are written as .npz files with the JAX script's
keys. The oracle is `ops/rasterizer_ref.py`, the JAX package's untiled
per-pixel oracle copied op for op (every Gaussian at every pixel, the
transmittance as exp of a cumulative sum of log1p), on the GPU or with
`--cpu` on the CPU, differentiated by autograd; the production rasterizer
and its CUDA kernels are held to these frames elsewhere
(tests/test_torch_blend_gpu.py, and chip_smoke.py's `tools`).

The scenes' random parts and the loss weights are `jax.random` draws in the
JAX script (PRNGKey(key) split five ways; PRNGKeys 7, 8 and 9). They are
drawn here by `utils/threefry`, JAX's default threefry PRNG in numpy, so
they equal JAX's bit for bit. The committed fixtures (tests/goldens/) were
written under that same default (`jax_threefry_partitionable`), and the
JAX script reproduces them today. This script's frames and gradients agree
with them to float32 rounding: frames to atol 1e-5 / rtol 1e-4 and
gradients to rtol 1e-4 with atol 1e-5 of each array's largest magnitude,
on every element. The JAX oracle's own test bound (atol 1e-6 / rtol 1e-5
on the frames, tests/test_goldens.py:70-80) is XLA's CPU rounding
reproducing itself: a float64 render of the same inputs misses it too. So
fixtures written here would not pass that JAX test, and tests/goldens/
stays the JAX script's.

`--out` is required: the fixtures under tests/goldens/ are the JAX
package's and are not rewritten by this script.

Usage:
    python -m manigaussian_tpu_torch.scripts.make_goldens --out /tmp/goldens
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from manigaussian_tpu_torch.data.synthetic import _intrinsics, _look_at
from manigaussian_tpu_torch.utils import threefry

CENTER = np.array([0.2, 0.0, 1.1], np.float32)
PARAM_KEYS = ("means3d", "scales", "rotations", "opacities", "shs",
              "language_features")


def tabletop_depth(h, w):
    """Analytic depth: table plane + sphere sitting on it, viewed from above-
    front (RLBench tabletop geometry, deterministic)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (xs - w / 2.0) / w
    v = (ys - h / 2.0) / h
    depth = 1.05 + 0.25 * v                      # tilted table plane
    r2 = (u - 0.05) ** 2 + (v + 0.1) ** 2
    sphere = r2 < 0.09
    depth = np.where(sphere, depth - 0.35 * np.sqrt(np.maximum(0.09 - r2, 0)),
                     depth)
    return depth.astype(np.float32)


def scene_from_depth(h=32, w=32, key=0, device="cpu"):
    """Depth map → unprojected pcd → Gaussian params (deterministic)."""
    import torch

    from manigaussian_tpu_torch.ops import camera as cam
    obs_pose = _look_at(CENTER + np.array([0.0, -0.8, 0.5]), CENTER)
    intr = _intrinsics(h, w, focal=float(w))
    depth = tabletop_depth(h, w)
    w2c = np.linalg.inv(obs_pose)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    pcd = cam.depth_to_pointcloud(t(depth), t(w2c), t(intr)).cpu().numpy()
    means = pcd.reshape(-1, 3)
    n = means.shape[0]

    ks = threefry.split(threefry.prng_key(key), 5)
    # colors: smooth position-derived pattern (surface-coherent like RGB obs)
    rgbn = (means - means.min(0)) / (np.ptp(means, 0) + 1e-6)
    sh_dc = (rgbn - 0.5) / 0.28209479177387814          # SH C0 inverse
    shs = np.zeros((n, 4, 3), np.float32)
    shs[:, 0] = sh_dc
    shs[:, 1:] = 0.15 * threefry.normal(ks[0], (n, 3, 3))
    scales = np.full((n, 3), 0.02, np.float32) * threefry.uniform(
        ks[1], (n, 3), minval=0.5, maxval=2.0)
    q = threefry.normal(ks[2], (n, 4))
    rotations = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
        np.float32)
    opacities = threefry.uniform(ks[3], (n,), minval=0.3, maxval=0.95)
    lang = threefry.normal(ks[4], (n, 3))
    return dict(means3d=means.astype(np.float32), scales=scales,
                rotations=rotations, opacities=opacities,
                shs=shs.astype(np.float32), language_features=lang)


def degenerate_scene(base):
    """Sparse variant exercising culls/clamps: every 8th splat, plus splats
    behind the camera, at the frustum edge, and one giant splat."""
    s = {k: v[::8].copy() for k, v in base.items()}
    s["means3d"] = np.concatenate([
        s["means3d"],
        CENTER + np.array([[0.0, -2.0, 0.0]], np.float32),     # behind camera
        CENTER + np.array([[5.0, 0.0, 0.0]], np.float32),      # far off-frustum
        CENTER[None] + 0.0,                                     # giant center
    ]).astype(np.float32)
    pad = lambda v, fill: np.concatenate(
        [v, np.broadcast_to(np.asarray(fill, v.dtype), (3,) + v.shape[1:])])
    s["scales"] = np.concatenate(
        [s["scales"], [[0.02] * 3, [0.02] * 3, [0.6] * 3]]).astype(np.float32)
    s["rotations"] = pad(s["rotations"], [1, 0, 0, 0])
    s["opacities"] = np.concatenate(
        [s["opacities"], [0.9, 0.9, 0.8]]).astype(np.float32)
    s["shs"] = pad(s["shs"], np.zeros((4, 3), np.float32))
    s["language_features"] = pad(s["language_features"], [1.0, -1.0, 0.5])
    return s


def loss_weights(height, width):
    """The loss's fixed weights: normal draws of PRNGKeys 7, 8 and 9."""
    return (threefry.normal(threefry.prng_key(7), (height * width, 3)),
            threefry.normal(threefry.prng_key(8), (height * width, 3)),
            threefry.normal(threefry.prng_key(9), (height * width,)))


def render_and_grads(scene, novel_eye, width, height, znear=0.1, zfar=4.0,
                     device="cpu"):
    import torch

    from manigaussian_tpu_torch.ops import camera as cam
    from manigaussian_tpu_torch.ops.rasterizer_ref import rasterize_reference
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    intr = _intrinsics(height, width, focal=float(width))
    c2w = _look_at(CENTER + np.asarray(novel_eye, np.float32), CENTER)
    camera = cam.novel_camera_calib(t(intr), t(c2w), znear, zfar, height,
                                    width)
    wc, wl, wt = (t(x) for x in loss_weights(height, width))
    params = {k: t(scene[k]).requires_grad_() for k in PARAM_KEYS}
    out = rasterize_reference(
        params["means3d"], params["opacities"], camera, width, height,
        (0.0, 0.0, 0.0), params["scales"], params["rotations"], params["shs"],
        params["language_features"], sh_degree=1)
    loss = (torch.sum(out.color.reshape(-1, 3) * wc)
            + torch.sum(out.language_feature.reshape(-1, 3) * wl)
            + torch.sum(out.final_t.reshape(-1) * wt))
    loss.backward()
    host = lambda x: x.detach().cpu().numpy()
    rec = dict(scene)
    rec.update(
        intrinsic=intr, c2w=c2w, znear=znear, zfar=zfar,
        width=width, height=height, loss=np.float32(host(loss)),
        golden_color=host(out.color), golden_lang=host(out.language_feature),
        golden_final_t=host(out.final_t),
        golden_radii=host(out.radii).astype(np.int32))
    for k in PARAM_KEYS:
        rec[f"grad_{k}"] = host(params[k].grad)
    return rec


def make(out_dir: str, device="cpu") -> dict:
    """Both fixtures into `out_dir`; returns {name: record}."""
    os.makedirs(out_dir, exist_ok=True)
    base = scene_from_depth(32, 32, key=0, device=device)
    recs = {
        "tabletop_dense": render_and_grads(
            base, novel_eye=(0.55, -0.55, 0.45), width=64, height=64,
            device=device),
        "tabletop_sparse": render_and_grads(
            degenerate_scene(base), novel_eye=(0.0, -0.75, 0.55), width=32,
            height=32, device=device)}
    for name, rec in recs.items():
        np.savez_compressed(os.path.join(out_dir, name + ".npz"), **rec)
        print(f"{name}: N={rec['means3d'].shape[0]} loss={rec['loss']:.6f}")
    return recs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True,
                        help="directory for tabletop_{dense,sparse}.npz")
    parser.add_argument("--cpu", action="store_true",
                        help="render on the CPU instead of the GPU")
    args = parser.parse_args(argv)
    from manigaussian_tpu_torch.utils.device import resolve_device
    return make(args.out, resolve_device("cpu" if args.cpu else None))


if __name__ == "__main__":
    main()
