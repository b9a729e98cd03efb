"""Rank processes of the port's multi-device tests (tests/test_torch_parallel_*.py).

Each worker is one rank of a gloo group on the CPU, started by `run_ranks`
with torch.multiprocessing (spawn). This module imports no JAX, so a rank
starts in a second or two; the tests compute the JAX references in their
own process. Every rank writes what it computed to `<out>/rank<r>.pt`.
"""

import os
import time

import torch

from manigaussian_tpu_torch.parallel.distributed import free_port

THREADS = 2   # per rank: tier-1 runs several test files at once


def run_ranks(fn, world: int, args: tuple = (), timeout: float = 180.0):
    """Start `world` ranks running fn(rank, port, world, *args) and wait for
    them, at most `timeout` seconds in all: a rank that hangs fails the test
    (every rank is killed) rather than stalling the suite."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(free_port(), world) + tuple(args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _init(rank, port, world):
    from manigaussian_tpu_torch.parallel.distributed import (dist_spec,
                                                             init_distributed)
    torch.set_num_threads(THREADS)
    init_distributed(dist_spec(port, world, rank), "cpu")


def _save(out, rank, obj):
    torch.save(obj, os.path.join(out, f"rank{rank}.pt"))


def mesh_worker(rank, port, world, shape, axes, out):
    """The mesh's coordinates and groups; the collectives and the two
    autograd functions over each axis."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.parallel import distributed as D
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    _init(rank, port, world)
    mesh = make_mesh(shape, axes)
    res = {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
           "groups": {a: dist.get_process_group_ranks(mesh.group(a))
                      for a in axes}}
    for a in axes:
        g, i, n = mesh.group(a), mesh.index(a), mesh.size(a)
        gen = torch.Generator().manual_seed(100 + rank)
        mine = torch.randn(3, 4, generator=gen)
        mine[0, 0] = 1e30 * (rank + 1)
        mine[0, 1] = 1e-40 * (rank + 1)      # subnormal
        mine[0, 2] = float("inf")
        res[f"{a}/mine"] = mine
        res[f"{a}/gathered"] = D.gather_rows(mine, g)
        v = torch.tensor([float(rank), -2.0 * rank, 1.0])
        res[f"{a}/reduced"] = {op: D.all_reduce(v, op, g)
                               for op in ("sum", "mean", "min", "max")}
        # replicate: the identity; the gradient summed over the group
        x = torch.linspace(-1.0, 1.0, 6).reshape(2, 3).requires_grad_()
        y = torch.arange(4.0).requires_grad_()
        xr, yr = D.replicate(g, x, y)
        ((xr * (rank + 1)).sum() + (yr * yr).sum() * rank).backward()
        res[f"{a}/replicate"] = (torch.equal(xr.detach(), x.detach()),
                                 x.grad.clone(), y.grad.clone())
        # gather_patches: the rank's own rows of the gradient, the anchor 0
        p = (torch.randn(2, 5, generator=gen) + i).requires_grad_()
        anchor = torch.ones(3, requires_grad=True)
        full = D.gather_patches(p, g, anchor * 2.0)
        w = torch.arange(float(full.numel())).reshape(full.shape)
        (full * w).sum().backward()
        res[f"{a}/patches"] = (full.detach(), p.detach(), p.grad.clone(),
                               anchor.grad.clone(), w[2 * i:2 * i + 2])
        res[f"{a}/size_index"] = (n, i)
    mine = torch.randn(4, 2, generator=torch.Generator().manual_seed(9))
    res["in_sync_same"] = D.params_in_sync([mine])
    res["in_sync_differ"] = D.params_in_sync([mine + rank])
    _save(out, rank, res)
    dist.destroy_process_group()


def raster_worker(rank, port, world, scene, out):
    """`rasterize_sharded` over a ("tile",) mesh of every rank: the images,
    the overflow counters, and the gradients of a loss on the color and
    the features with respect to every input."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.ops.camera import novel_camera_calib
    from manigaussian_tpu_torch.ops.rasterizer import RasterizeConfig
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    from manigaussian_tpu_torch.parallel.rasterizer_sharded import \
        rasterize_sharded
    _init(rank, port, world)
    mesh = make_mesh((world,), ("tile",))
    res = {}
    for name, sc in scene.items():
        cfg = RasterizeConfig(**sc["cfg"])
        cam = novel_camera_calib(*(torch.from_numpy(sc[k])[None]
                                   for k in ("intr", "c2w")),
                                 0.1, 4.0, cfg.height, cfg.width)
        ins = [torch.from_numpy(sc[k])[None].requires_grad_()
               for k in ("means3d", "opacities", "scales", "rotations", "shs",
                         "language_features")]
        o, e = rasterize_sharded(mesh, ins[0], ins[1], cam, cfg, sc["bg"],
                                 ins[2], ins[3], ins[4], ins[5])
        loss = ((o.color - torch.from_numpy(sc["target"])[None]) ** 2).sum() \
            + (o.language_feature ** 2).sum() * 0.1
        loss.backward()
        res[name] = {"color": o.color[0].detach(),
                     "lang": o.language_feature[0].detach(),
                     "final_t": o.final_t[0].detach(), "radii": o.radii[0],
                     "overflow_splats": int(e.overflow_splats),
                     "overflow_gaussians": int(e.overflow_gaussians),
                     "grads": [x.grad[0].clone() for x in ins]}
    _save(out, rank, res)
    dist.destroy_process_group()


def train_cfg(cfg_dict):
    from manigaussian_tpu_torch.config import ManiGaussianConfig
    from manigaussian_tpu_torch.utils.config_io import from_dict
    return from_dict(cfg_dict, ManiGaussianConfig())


def one_process_steps(cfg, batches, starts, seed: int = 3, draws=None):
    """The port's one-process update on the global batches, step k run from
    `starts[k]` (what a rank held before its step k: the parameters, the
    optimizer's state, the step count and the generator's state): a list of
    (metrics, gradients, parameters after the step, what the next step
    starts from), one a step. It runs at the ranks' thread count, whatever
    the caller's: the reductions' order follows the thread count."""
    from manigaussian_tpu_torch.agents.registry import create_agent
    caller_threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        agent = create_agent(cfg, device="cpu", seed=seed)
        gen = torch.Generator()
        out = []
        for i, (b, start) in enumerate(zip(batches, starts)):
            with torch.no_grad():
                for p, w in zip(agent.qfn.parameters(), start["params"]):
                    p.copy_(w)
            agent.optimizer().load_state_dict(start["opt"])
            agent.step = start["step"]
            gen.set_state(start["gen"])
            m = agent.update(b, gen, None if draws is None else draws[i])
            out.append(({k: float(v) for k, v in m.items()}, _grads(agent),
                        _params(agent), _start(agent, gen)))
        return out
    finally:
        torch.set_num_threads(caller_threads)


def _grads(agent):
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            for p in agent.qfn.parameters()]


def _params(agent):
    return [p.detach().clone() for p in agent.qfn.parameters()]


def _start(agent, gen):
    """What the next step starts from, as copies: the parameters, the
    optimizer's state, the step count and the generator's state."""
    opt = agent.optimizer().state_dict()
    opt["mu"] = [m.clone() for m in opt["mu"]]
    opt["nu"] = [v.clone() for v in opt["nu"]]
    return {"params": _params(agent), "opt": opt, "step": agent.step,
            "gen": gen.get_state()}


def train_worker(rank, port, world, shape, axes, cfg_dict, batches, out,
                 draws=None, seed=3, state_path=None):
    """The sharded update on a mesh of `shape` over `axes` ("data" and/or
    "tile"), every rank from the same seeded weights and generator, on the
    same global batches. By step: what the step started from (`_start`),
    its metrics, and the gradients and parameters after it; what a next
    step would start from (`end`); and whether every rank holds the same
    parameters bit for bit at the end.
    `state_path`: a state dict to start from instead."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.parallel.distributed import params_in_sync
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    from manigaussian_tpu_torch.parallel.train_sharded import \
        make_sharded_update
    _init(rank, port, world)
    mesh = make_mesh(shape, axes)
    agent = create_agent(train_cfg(cfg_dict), device="cpu", seed=seed,
                         tile_mesh=mesh if "tile" in mesh else None)
    if state_path is not None:
        agent.qfn.load_state_dict(torch.load(state_path))
    step = make_sharded_update(agent, mesh)
    gen = torch.Generator().manual_seed(0)
    res = {"starts": [], "metrics": [], "grads": [], "params": []}
    for i, b in enumerate(batches):
        res["starts"].append(_start(agent, gen))
        m = step(b, gen, None if draws is None else draws[i])
        res["metrics"].append({k: float(v) for k, v in m.items()})
        res["grads"].append(_grads(agent))
        res["params"].append(_params(agent))
    res["end"] = _start(agent, gen)
    res["in_sync"] = params_in_sync(_params(agent))
    _save(out, rank, res)
    dist.destroy_process_group()


def act_worker(rank, port, world, cfg_dict, observation, out):
    """`make_sharded_act` over a ("data",) mesh of every rank: the actions
    of the whole observation batch, each rank acting on its rows."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.parallel.mesh import make_mesh
    from manigaussian_tpu_torch.parallel.train_sharded import make_sharded_act
    _init(rank, port, world)
    mesh = make_mesh((world,), ("data",))
    agent = create_agent(train_cfg(cfg_dict), device="cpu", seed=3)
    res = make_sharded_act(agent, mesh)(observation)
    _save(out, rank, [x.clone() for x in res])
    dist.destroy_process_group()


def adam_replicate_worker(rank, port, world, out):
    """`replicate_state` with an AdamW: each rank steps its own module and
    optimizer differently (rank 0 three times), then takes rank 0's."""
    import torch.distributed as dist

    from manigaussian_tpu_torch.parallel.mesh import replicate_state
    from manigaussian_tpu_torch.utils.optimizers import AdamW
    _init(rank, port, world)
    torch.manual_seed(rank)
    module = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = AdamW(module.parameters(), 1e-2, weight_decay=1e-4)
    for _ in range(3 if rank == 0 else 1):
        for p in opt.params:
            p.grad = torch.randn_like(p)
        opt.step()
    ref = [p.detach().clone() for p in opt.params]
    replicate_state(module, opt)
    _save(out, rank, {
        "count": opt.count, "mu": [m.clone() for m in opt.mu],
        "nu": [v.clone() for v in opt.nu], "params": _params_of(module),
        "was_different": any(not torch.equal(a, b)
                             for a, b in zip(ref, opt.params))})
    dist.destroy_process_group()


def _params_of(module):
    return [p.detach().clone() for p in module.parameters()]


def eval_worker_probe(payload):
    """The eval runner's spawn worker on `payload`, then the modules of JAX
    and of the JAX package that its process has imported."""
    import sys

    from manigaussian_tpu_torch.runners.eval_runner import _eval_worker
    row = _eval_worker(payload)
    banned = ("jax", "jaxlib", "flax", "optax", "manigaussian_tpu")
    return row, sorted(m for m in sys.modules if m.split(".")[0] in banned)
