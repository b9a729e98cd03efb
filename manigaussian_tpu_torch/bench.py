"""Benchmark of the port: fwd+bwd differentiable Gaussian-splat renders a
second on one GPU, `python -m manigaussian_tpu_torch.bench`.

The twin of the root `bench.py` (its `make_scene`, `make_camera` and
`_benchmark`): 65,536 Gaussians (SH degree 1, RGB plus 3 language
channels) rendered at 128² through `ops/rasterizer.rasterize` on the kernel
route, with `RasterizeConfig(tile=16, max_tiles_per_gaussian=16,
tile_capacity=8192, chunk=512, sh_degree=1)`, the loss
Σ(color − target)² + Σ lang², and the gradient of all six inputs; one
warm-up, then 30 timed iterations closed by `torch.cuda.synchronize()`.

Prints the overflow counts (splats past `tile_capacity`, rect slots past
`max_tiles_per_gaussian`) on a line of their own, then one JSON line with
the root bench's keys. `vs_baseline` is null: the root bench's target is a
figure for another accelerator, not a baseline of this one. Runs on the
GPU; `--cpu` runs it on the CPU, and `--n` / `--size` shrink it (a test
runs `--cpu --n 512 --size 32`).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from manigaussian_tpu_torch.ops.camera import novel_camera_calib
from manigaussian_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device

METRIC = "fwd_bwd_renders_per_s_per_chip_128px_65k"
ITERS = 30
SCENE_KEYS = ("means", "scales", "rotations", "opacities", "shs", "lang")


def make_scene(n: int, generator: torch.Generator, device="cpu"):
    """The root bench's scene distributions, drawn from `generator` (a CPU
    generator) and moved to `device`: means U(-0.4, 0.4) + (0, 0, 1.6),
    scales exp(U(log 0.002, log 0.02)), unit quaternions, opacities
    U(0.2, 0.9), SH degree 1 N(0, 0.3²), 3 language channels N(0, 1).
    Returns a dict of SCENE_KEYS."""
    u = lambda *shape: torch.rand(*shape, generator=generator)
    means = (u(n, 3) * 0.8 - 0.4) + torch.tensor([0.0, 0.0, 1.6])
    lo, hi = math.log(0.002), math.log(0.02)
    scales = torch.exp(lo + u(n, 3) * (hi - lo))
    q = torch.randn(n, 4, generator=generator)
    rotations = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    opacities = 0.2 + u(n) * 0.7
    shs = torch.randn(n, 4, 3, generator=generator) * 0.3
    lang = torch.randn(n, 3, generator=generator)
    scene = (means, scales, rotations, opacities, shs, lang)
    return {k: v.to(device) for k, v in zip(SCENE_KEYS, scene)}


def make_camera(size: int, device="cpu"):
    """A size² pinhole camera at the origin looking along +z, focal = size."""
    intr = torch.tensor([[float(size), 0.0, size / 2.0],
                         [0.0, float(size), size / 2.0],
                         [0.0, 0.0, 1.0]], device=device)
    return novel_camera_calib(intr, torch.eye(4, device=device), 0.1, 4.0,
                              size, size)


def bench_config(size: int) -> RasterizeConfig:
    return RasterizeConfig(width=size, height=size, tile=16,
                           max_tiles_per_gaussian=16, tile_capacity=8192,
                           chunk=512, sh_degree=1)


def loss_and_grads(scene, camera, cfg: RasterizeConfig, target):
    """The bench's loss and the gradients of the six scene tensors, and the
    overflow counts (0-d tensors)."""
    params = {k: v.detach().requires_grad_() for k, v in scene.items()}
    out, extras = rasterize(params["means"], params["opacities"], camera, cfg,
                            (0.0, 0.0, 0.0), scales=params["scales"],
                            rotations=params["rotations"], shs=params["shs"],
                            language_features=params["lang"])
    loss = (((out.color - target) ** 2).sum()
            + (out.language_feature ** 2).sum())
    grads = torch.autograd.grad(loss, [params[k] for k in SCENE_KEYS])
    return loss.detach(), dict(zip(SCENE_KEYS, grads)), extras


def run(n: int = 65536, size: int = 128, device: DeviceLike = None,
        iters: int = ITERS, seed: int = 0) -> dict:
    """Time `iters` fwd+bwd renders after one warm-up. Returns the result
    line's fields and the overflow counts."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    scene = make_scene(n, gen, dev)
    target = torch.rand(size, size, 3, generator=gen).to(dev)
    camera = make_camera(size, dev)
    cfg = bench_config(size)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    _, _, extras = loss_and_grads(scene, camera, cfg, target)     # warm-up
    overflow = {"overflow_splats": int(extras.overflow_splats),
                "overflow_gaussians": int(extras.overflow_gaussians)}
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss_and_grads(scene, camera, cfg, target)
    sync()
    dt = time.perf_counter() - t0
    return {"metric": METRIC, "value": round(iters / dt, 3),
            "unit": "renders/s", "vs_baseline": None, **overflow,
            "gaussians": n, "image": [size, size], "device": str(dev)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the GPU")
    parser.add_argument("--n", type=int, default=65536, help="Gaussians")
    parser.add_argument("--size", type=int, default=128,
                        help="image side in pixels")
    args = parser.parse_args(argv)
    res = run(args.n, args.size, device="cpu" if args.cpu else None)
    print(json.dumps({k: res[k] for k in ("overflow_splats",
                                          "overflow_gaussians", "gaussians",
                                          "image", "device")}), flush=True)
    print(json.dumps({k: res[k] for k in ("metric", "value", "unit",
                                          "vs_baseline")}), flush=True)
    return res


if __name__ == "__main__":
    main()
