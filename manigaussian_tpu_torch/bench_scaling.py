"""Scaling benchmark of the port: the tile-sharded renderer's rays/s and the
data-parallel train step's steps/s over D ranks, with a communication model
from the bytes each collective moves (the twin of the root
`bench_scaling.py`; `python -m manigaussian_tpu_torch.bench_scaling`).

One process drives one rank (`parallel/distributed.py`), so D counts
processes: `--cpu N` spawns N gloo ranks on the CPU (torch has no virtual
devices), `--dist HOST:PORT,NPROCS,PID` makes this process one rank of a
group started by hand (on its GPU; with `--cpu` on the CPU), and with
neither one process runs on the GPU. Rows are taken at D = 1 (rank 0 alone,
the unsharded path) and at D = the group's size. Every row says what it
measures (`method`), as the JAX script's do:

  strong_wallclock — 65,536 Gaussians (`--n`) rendered at `--size`², fwd +
      bwd (the gradient of the means), with the tiles split over D ranks
      (`parallel/rasterizer_sharded.py`); rays/s on rank 0's host clock
      around `--iters` renders that end in a device synchronization.
  weak_wallclock — the image grows with D (the pixels a rank renders held
      fixed); and `dp_train_steps_per_s`: the DP step (global batch D) of
      JAX's tiny config.
  comm_model — no scaling claim: one step run under
      `count_collective_bytes`, which sums the output bytes of every
      collective under the JAX HLO count's names (all-reduce, all-gather,
      reduce-scatter, collective-permute), then a no-overlap lower bound
      eff ≥ t_comp / (t_comp + bytes·(D−1)/D / BW). The port has no HLO to
      read: the bytes are what its collectives move (the render: the
      `replicate` backward's gradient sum and the patch gather; the DP
      step: the flat gradient buffer, the metrics and the PSNR's MSE).
      The DP step's model runs at `config.w_geo()` width, as JAX's does.

No TPU figure is used. `t_comp` is the D = 1 time measured in the same run
(render, or the `w_geo` step at batch 1) unless `--tcomp-render-ms` /
`--tcomp-step-ms` give it. The bandwidth is `NVLINK_BW_BYTES_PER_S`, an H100
SXM's NVLink 4 per direction; the JAX rows' `ici_bw_bytes_per_s` and
`projected_ici_efficiency_lower_bound` keep their meaning here as
`nvlink_bw_bytes_per_s` and `projected_nvlink_efficiency_lower_bound`.

`platform_limited` marks a D > 1 row whose ranks share the host's cores
(CPU) or one card (gloo on the GPU: NCCL refuses two ranks on one GPU, so
ranks sharing a card ask for `--dist-backend gloo`): such a row measures
the sharing, not the interconnect. `--backend` is the rasterizer's route
(`pallas`, the kernels; `xla`, the plain version), as in the JAX script.

    python -m manigaussian_tpu_torch.bench_scaling --cpu 2 --n 2048 --size 32
    python -m manigaussian_tpu_torch.bench_scaling --cpu 2 --comm-model --train-step
    python -m manigaussian_tpu_torch.bench_scaling --dist localhost:29500,2,0 \\
        --dist-backend gloo --weak --train-step     # and pid 1 beside it

Rank 0 prints one JSON line a row and appends it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from manigaussian_tpu_torch import config as C

# NVIDIA H100 SXM: NVLink 4, 18 links of 50 GB/s (25 GB/s each way), 900
# GB/s in both directions together (NVIDIA H100 Tensor Core GPU data
# sheet); one direction is what a ring collective's step uses
NVLINK_BW_BYTES_PER_S = 450e9
DEFAULT_OUT = os.path.join("build", "bench_scaling", "SCALING.jsonl")


def tiny_config() -> C.ManiGaussianConfig:
    """JAX's tiny config of its DP rows (`__graft_entry__._tiny_cfg`), its
    policy in float32: the bf16 flash kernels take head dims 16, 32 and 64,
    and this config's latent heads are 8 wide (the fp32 kernels take 8)."""
    nr = C.NeuralRendererConfig(
        use_dynamic_field=True, image_width=32, image_height=32,
        d_latent=16, mlp=C.MLPConfig(n_blocks=2, d_hidden=32),
        next_mlp=C.NextMLPConfig(d_hidden=32, n_blocks=2, warm_up=10),
        tile=16, max_tiles_per_gaussian=4, tile_capacity=64, chunk=32)
    method = C.MethodConfig(
        voxel_sizes=(20,), num_latents=32, latent_dim=32,
        transformer_depth=1, cross_dim_head=8, latent_dim_head=8,
        final_dim=16, policy_dtype="float32", neural_renderer=nr)
    return C.ManiGaussianConfig(method=method)


def make_batch(b: int, ncam: int, h: int, w: int, img: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """A training batch with the keys and distributions of JAX's
    `__graft_entry__._make_batch` (numpy, from `seed`): a point cloud
    around (0.2, 0, 1.1), identity cameras, fixed action indices."""
    rng = np.random.default_rng(seed)
    f = np.float32
    center = np.array([0.2, 0.0, 1.1], f)
    intr = np.tile(np.array([[img, 0, img / 2.0], [0, img, img / 2.0],
                             [0, 0, 1.0]], f), (b, 1, 1))
    pose = np.tile(np.eye(4, dtype=f), (b, 1, 1))
    pose[:, 2, 3] = 0.0
    return {
        "rgb": rng.uniform(size=(b, ncam, h, w, 3)).astype(f),
        "pcd": (center + 0.08 * rng.standard_normal((b, ncam, h, w, 3))
                ).astype(f),
        "low_dim_state": np.zeros((b, 4), f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": np.full((b, 3), 10, np.int32),
        "rot_grip_action_indicies": np.tile(np.array([[10, 20, 30, 1]],
                                                     np.int32), (b, 1)),
        "ignore_collisions": np.ones((b, 1), np.int32),
        "gripper_pose": np.tile(np.concatenate([center, [0, 0, 0, 1.0]])
                                .astype(f)[None], (b, 1)),
        "action": np.zeros((b, 8), f),
        "camera_extrinsics": np.tile(np.eye(4, dtype=f), (b, ncam, 1, 1)),
        "nerf_target_rgb": rng.uniform(size=(b, img, img, 3)).astype(f),
        "nerf_target_pose": pose,
        "nerf_target_intrinsic": intr,
        "nerf_next_target_rgb": rng.uniform(size=(b, img, img, 3)).astype(f),
        "nerf_next_target_pose": pose.copy(),
        "nerf_next_target_intrinsic": intr.copy(),
    }


def tile_ok(d: int, size: int) -> bool:
    """The JAX script's rule: the tiles divide over d ranks, a whole number
    of tile rows each."""
    tx = size // 16
    nt = tx * tx
    return d == 1 or (nt % d == 0 and (nt // d) % tx == 0)


class _Run:
    """What every rank needs: its rank, the group's size, its device, the
    arguments, and rank 0's record of the rows."""

    def __init__(self, rank: int, world: int, device: torch.device, args):
        self.rank, self.world = rank, world
        self.device, self.args = device, args
        self.rows: List[Dict] = []
        self.platform = "gpu" if device.type == "cuda" else "cpu"
        self.gloo = world > 1 and (self.platform == "cpu"
                                   or args.dist_backend == "gloo")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        if self.world > 1:
            torch.distributed.barrier()

    def counts(self) -> List[int]:
        return [1] + ([self.world] if self.world > 1 else [])

    def limited(self, d: int) -> bool:
        return d > 1 and self.gloo

    def oversub(self, d: int) -> float:
        """Programs sharing the host's cores or the card (JAX: d ·
        processes on the CPU)."""
        return float(d) if self.limited(d) else 1.0

    def record(self, row: Dict) -> None:
        row = {**row, "platform": self.platform,
               "device": (torch.cuda.get_device_name(self.device)
                          if self.platform == "gpu" else "cpu"),
               "processes": self.world,
               "collective_backend": (
                   None if self.world == 1 else
                   torch.distributed.get_backend())}
        self.rows.append(row)
        if self.rank == 0:
            print(json.dumps(row), flush=True)
            out = self.args.out
            if os.path.dirname(out):
                os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")

    def timed(self, fn: Callable, iters: int) -> float:
        """Seconds a call of fn after one warm-up call."""
        fn()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        self.sync()
        return (time.perf_counter() - t0) / iters


# --------------------------------------------------------------- the render
def render_config(n: int, size: int, backend: str):
    from manigaussian_tpu_torch.ops.rasterizer import RasterizeConfig
    return RasterizeConfig(width=size, height=size, tile=16,
                           max_tiles_per_gaussian=16,
                           tile_capacity=min(8192, max(512, n // 8)),
                           chunk=256, sh_degree=1, backend=backend)


def render_step(run: _Run, scene: Dict, size: int, cfg, mesh=None):
    """fn() → the gradient of Σ(color − target)² with respect to the means,
    unsharded (mesh None) or with the tiles over the mesh's "tile" axis."""
    from manigaussian_tpu_torch.bench import make_camera
    from manigaussian_tpu_torch.ops.rasterizer import rasterize
    from manigaussian_tpu_torch.parallel.rasterizer_sharded import \
        rasterize_sharded
    cam = make_camera(size, run.device)
    target = torch.rand(size, size, 3,
                        generator=torch.Generator().manual_seed(1)).to(
                            run.device)
    rest = {k: scene[k] for k in ("opacities", "scales", "rotations", "shs",
                                  "lang")}

    def fn():
        m = scene["means"].detach().requires_grad_()
        if mesh is None:
            out, _ = rasterize(m, rest["opacities"], cam, cfg, (0., 0., 0.),
                               scales=rest["scales"],
                               rotations=rest["rotations"], shs=rest["shs"],
                               language_features=rest["lang"])
            color = out.color
        else:
            cam_b = type(cam)(*(f[None] for f in cam))
            out, _ = rasterize_sharded(
                mesh, m[None], rest["opacities"][None], cam_b, cfg,
                (0., 0., 0.), scales=rest["scales"][None],
                rotations=rest["rotations"][None], shs=rest["shs"][None],
                language_features=rest["lang"][None])
            color = out.color[0]
        loss = ((color - target) ** 2).sum()
        return torch.autograd.grad(loss, m)[0]

    return fn


def _scene(run: _Run, n: int) -> Dict:
    from manigaussian_tpu_torch.bench import make_scene
    return make_scene(n, torch.Generator().manual_seed(0), run.device)


def _tile_mesh(run: _Run, d: int):
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    return None if d == 1 else make_mesh((d,), ("tile",))


def render_rows(run: _Run) -> None:
    a = run.args
    scene = _scene(run, a.n)
    cfg = render_config(a.n, a.size, a.backend)
    rays = a.size * a.size
    base = None
    for d in run.counts():
        if not tile_ok(d, a.size):
            continue
        mesh = _tile_mesh(run, d)
        dt = None
        if run.rank < d:
            dt = run.timed(render_step(run, scene, a.size, cfg, mesh),
                           a.iters)
        run.barrier()
        if run.rank != 0:
            continue
        rate = rays / dt
        base = base or rate
        eff = rate / (base * d)
        run.record({
            "metric": "rays_per_s_fwd_bwd", "method": "strong_wallclock",
            "devices": d, "value": round(rate, 1),
            "efficiency_vs_1": round(eff, 3),
            "core_share_adjusted_efficiency": round(eff * run.oversub(d), 3),
            "platform_limited": run.limited(d), "backend": a.backend,
            "n_gaussians": a.n, "size": a.size})


def weak_rows(run: _Run) -> None:
    """The image area grows with D (side ∝ √D, whole tile rows a rank)."""
    a = run.args
    scene = _scene(run, a.n)
    base = None
    for d in run.counts():
        size_d = a.size
        while (size_d * size_d) // 256 < d or not tile_ok(d, size_d):
            size_d += 16
        cfg = render_config(a.n, size_d, a.backend)
        mesh = _tile_mesh(run, d)
        dt = None
        if run.rank < d:
            dt = run.timed(render_step(run, scene, size_d, cfg, mesh),
                           a.iters)
        run.barrier()
        if run.rank != 0:
            continue
        rate = (size_d * size_d / d) / dt
        base = base or rate
        run.record({
            "metric": "rays_per_s_per_device_weak",
            "method": "weak_wallclock", "devices": d, "size": size_d,
            "value": round(rate, 1), "efficiency_vs_1": round(rate / base, 3),
            "core_share_adjusted_efficiency": round(
                rate / base * run.oversub(d), 3),
            "platform_limited": run.limited(d), "backend": a.backend,
            "n_gaussians": a.n})


def render_comm_rows(run: _Run) -> None:
    """comm_model rows of the sharded render: its collectives' bytes on
    rank 0 during one fwd + bwd."""
    from manigaussian_tpu_torch.parallel.distributed import \
        count_collective_bytes
    a = run.args
    scene = _scene(run, a.n)
    cfg = render_config(a.n, a.size, a.backend)
    t_comp_ms = a.tcomp_render_ms
    if t_comp_ms is None:
        dt = (run.timed(render_step(run, scene, a.size, cfg), a.iters)
              if run.rank == 0 else None)
        t_comp_ms = dt * 1e3 if dt is not None else None
    run.barrier()
    for d in run.counts()[1:]:
        if not tile_ok(d, a.size):
            continue
        step = render_step(run, scene, a.size, cfg, _tile_mesh(run, d))
        with count_collective_bytes() as byts:
            step()
            run.sync()
        if run.rank == 0:
            run.record(_comm_row("render_comm_model", d, dict(byts),
                                 t_comp_ms, a.tcomp_render_ms is None,
                                 {"backend": a.backend, "n_gaussians": a.n,
                                  "size": a.size}))


def _comm_row(metric: str, d: int, byts: Dict, t_comp_ms: float,
              measured: bool, extra: Dict) -> Dict:
    total = sum(byts.values())
    t_comm = total * (d - 1) / d / NVLINK_BW_BYTES_PER_S
    t_comp = t_comp_ms / 1e3
    return {"metric": metric, "method": "comm_model", "devices": d,
            "collective_bytes": byts, "total_collective_bytes": total,
            "t_comm_no_overlap_ms": round(t_comm * 1e3, 4),
            "t_comp_measured_ms": t_comp_ms,
            "t_comp_source": ("D=1, this run" if measured
                              else "--tcomp flag"),
            "nvlink_bw_bytes_per_s": NVLINK_BW_BYTES_PER_S,
            "projected_nvlink_efficiency_lower_bound": round(
                t_comp / (t_comp + t_comm), 4), **extra}


# ------------------------------------------------------------ the DP step
def _dp_step(run: _Run, cfg, d: int, img: int):
    """(agent, fn): fn() runs one training step of `cfg` on global batch d
    (`make_batch`), data-parallel over the group when d > 1, and returns
    the metrics after a device synchronization."""
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    from manigaussian_tpu_torch.parallel.train_sharded import \
        make_sharded_update
    agent = create_agent(cfg, device=run.device, seed=1)
    batch = make_batch(d, 1, img, img, img)
    gen = torch.Generator().manual_seed(2)
    step = (agent.update if d == 1 else
            make_sharded_update(agent, make_mesh((d,), ("data",))))

    def fn():
        m = step(batch, gen)
        float(m["total_loss"])
        return m

    return agent, fn


def train_rows(run: _Run) -> None:
    """`dp_train_steps_per_s`: JAX's tiny config at global batch D (32²)."""
    a = run.args
    base = None
    for d in run.counts():
        dt = None
        if run.rank < d:
            _, fn = _dp_step(run, tiny_config(), d, 32)
            dt = run.timed(fn, a.iters)
        run.barrier()
        if run.rank != 0:
            continue
        rate = 1.0 / dt
        base = base or rate
        run.record({
            "metric": "dp_train_steps_per_s", "method": "weak_wallclock",
            "devices": d, "global_batch": d, "value": round(rate, 2),
            "efficiency_vs_1": round(rate / base, 3),
            "core_share_adjusted_efficiency": round(
                rate / base * run.oversub(d), 3),
            "platform_limited": run.limited(d)})


def train_comm_rows(run: _Run, cfg) -> None:
    """The DP step's comm_model row at `cfg`'s width (the CLI: `w_geo`,
    128² images), D = the group's size: the bytes counted in one step on
    rank 0, beside the port's own reckoning: the flat float32 gradient
    buffer (`param_bytes`), the metrics' float64 stack (`metric_bytes`) and
    the batch PSNR's MSE (4 bytes)."""
    from manigaussian_tpu_torch.parallel.distributed import \
        count_collective_bytes
    from manigaussian_tpu_torch.parallel.train_sharded import GLOBAL
    a = run.args
    img = cfg.method.neural_renderer.image_width
    t_comp_ms = a.tcomp_step_ms
    if t_comp_ms is None and run.rank == 0:
        agent, fn = _dp_step(run, cfg, 1, img)
        t_comp_ms = run.timed(fn, a.iters) * 1e3
        del agent, fn
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
    run.barrier()
    d = run.world
    if d == 1:
        return
    agent, fn = _dp_step(run, cfg, d, img)
    with count_collective_bytes() as byts:
        metrics = fn()
    if run.rank != 0:
        return
    param_bytes = sum(p.numel() * 4 for p in agent.qfn.parameters())
    metric_bytes = 8 * sum(1 for k in metrics if k not in GLOBAL)
    run.record(_comm_row(
        "dp_train_step_comm_model", d, dict(byts), t_comp_ms,
        a.tcomp_step_ms is None,
        {"param_bytes": param_bytes, "metric_bytes": metric_bytes,
         "reckoned_all_reduce_bytes": param_bytes + metric_bytes + 4}))


# ------------------------------------------------------------ entry points
def run_rank(rank: int, world: int, device: torch.device, args,
             train_cfg: Optional[C.ManiGaussianConfig] = None) -> List[Dict]:
    """This rank's part of the benchmark; rank 0 returns the rows.
    `train_cfg` is the DP comm model's config (default `config.w_geo()`)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run = _Run(rank, world, device, args)
    if args.comm_model:
        render_comm_rows(run)
        if args.train_step:
            train_comm_rows(run, train_cfg or C.w_geo())
        return run.rows
    render_rows(run)
    if args.weak:
        weak_rows(run)
    if args.train_step:
        train_rows(run)
    return run.rows


def _spawned_rank(rank: int, port: int, world: int, args, train_cfg) -> None:
    from manigaussian_tpu_torch.parallel.distributed import (dist_spec,
                                                             init_distributed)
    dev = init_distributed(dist_spec(port, world, rank), "cpu")
    try:
        run_rank(rank, world, dev, args, train_cfg)
    finally:
        torch.distributed.destroy_process_group()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Scaling rows of the port's sharded render and DP step")
    parser.add_argument("--cpu", type=int, default=0,
                        help="run N gloo ranks on the CPU (spawned here; "
                             "with --dist: this rank on the CPU)")
    parser.add_argument("--dist", default=None,
                        metavar="HOST:PORT,NPROCS,PID",
                        help="this process is one rank (train.py's spec)")
    parser.add_argument("--dist-backend", default=None,
                        choices=("nccl", "gloo"),
                        help="process group backend with --dist on the GPU "
                             "(gloo for ranks that share a card)")
    parser.add_argument("--n", type=int, default=65536, help="gaussians")
    parser.add_argument("--size", type=int, default=128, help="image px")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--backend", default="pallas",
                        choices=("pallas", "xla"),
                        help="rasterizer route: the kernels or the plain "
                             "version")
    parser.add_argument("--train-step", action="store_true",
                        help="also the DP train step's rows")
    parser.add_argument("--comm-model", action="store_true",
                        help="comm_model rows only: the collectives' bytes "
                             "of one step and the projected efficiency")
    parser.add_argument("--weak", action="store_true",
                        help="also weak-scaling rows (the image grows with "
                             "D)")
    parser.add_argument("--tcomp-render-ms", type=float, default=None,
                        help="t_comp of the render comm model (default: "
                             "the D=1 render measured in this run)")
    parser.add_argument("--tcomp-step-ms", type=float, default=None,
                        help="t_comp of the DP comm model (default: the "
                             "D=1 w_geo step measured in this run)")
    parser.add_argument("--out", default=DEFAULT_OUT)
    return parser.parse_args(argv)


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    if args.dist:
        from manigaussian_tpu_torch.parallel.distributed import (
            init_distributed, parse_spec)
        _, _, world, rank = parse_spec(args.dist)
        dev = init_distributed(args.dist, "cpu" if args.cpu else "cuda",
                               args.dist_backend)
        try:
            return run_rank(rank, world, dev, args)
        finally:
            torch.distributed.destroy_process_group()
    if args.cpu > 1:
        from manigaussian_tpu_torch.parallel.distributed import spawn_local
        spawn_local(_spawned_rank, args.cpu, (args.cpu, args, None))
        return []
    from manigaussian_tpu_torch.utils.device import resolve_device
    return run_rank(0, 1, resolve_device("cpu" if args.cpu else None), args)


if __name__ == "__main__":
    main()
