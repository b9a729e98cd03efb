"""The data-parallel train step and act (counterpart of
`manigaussian_tpu/parallel/train_sharded.py`).

JAX jits `agent.update` with the batch sharded on the "data" axis and lets
XLA insert the gradient sum. Here each rank runs `agent.update` on its rows
of the global batch (`shard_batch`; a mesh with only a "tile" axis keeps the
whole batch); after the backward, every gradient is averaged over the
mesh's ranks by one all-reduce of a flat float32 buffer in parameter order
(`average_gradients`), so every rank holds the same average bit for bit and
takes the same LAMB step: the parameters never drift apart.
The logged metrics are reduced over the group the same way
(`reduce_metrics`): means of the ranks' means (the losses are means over
equal row counts), sums of the overflow counters, and the PSNR as the
renderer computed it from the averaged MSE.

    mesh = make_mesh((D,), ("data",))
    step = make_sharded_update(agent, mesh)
    metrics = step(global_batch, generator)
"""

from __future__ import annotations

from typing import Dict

import torch

from manigaussian_tpu_torch.parallel.distributed import (flat_all_reduce,
                                                         gather_rows)
from manigaussian_tpu_torch.parallel.mesh import shard_batch

SUMMED = ("overflow_splats", "overflow_gaussians")
GLOBAL = ("psnr",)   # taken over the global batch already


@torch.no_grad()
def average_gradients(params, mesh) -> None:
    """Set each parameter's `.grad` to its mean over every rank of the mesh:
    the mean over the data group of the tile group's gradients, which are
    equal in exact arithmetic (each tile rank runs the same loss) but not
    bit for bit on the card (CUDA's atomics in some backwards, the
    trilinear upsample's among them), so the one reduction keeps every
    rank's parameters equal. A parameter the rank's loss did not reach
    (`.grad` None: its rows gave it no gradient) takes part with zeros, so
    every rank reduces the same buffer whatever its data."""
    params = list(params)
    means = flat_all_reduce([torch.zeros_like(p) if p.grad is None else p.grad
                             for p in params], "mean", None)
    for p, g in zip(params, means):
        p.grad = g


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh
                   ) -> Dict[str, torch.Tensor]:
    """The step's metrics of the global batch from every rank's: one
    float64 all-reduce over the data group."""
    if "data" not in mesh:
        return metrics
    keys = [k for k in metrics if k not in GLOBAL]
    total = mesh.all_reduce(torch.stack([metrics[k].double() for k in keys]),
                            "data", "sum")
    n = mesh.size("data")
    out = dict(metrics)
    for k, v in zip(keys, total):
        out[k] = (v if k in SUMMED else v / n).to(metrics[k].dtype)
    return out


def make_sharded_update(agent, mesh):
    """step(batch, generator, draws=None) → metrics: this rank's share of
    the data-parallel update on the identical global `batch` every rank
    holds (the augmentation `draws`, when given, are the global batch's)."""

    def step(batch, generator: torch.Generator, draws=None):
        return agent.update(shard_batch(batch, mesh), generator, draws,
                            mesh=mesh)

    return step


def make_sharded_act(agent, mesh):
    """act(observation) → ActResult of the global batch: each rank acts on
    its rows of the observation and the rows are gathered over the data
    group."""
    from manigaussian_tpu_torch.agents.bc_agent import ActResult

    def act(observation):
        res = agent.act(shard_batch(observation, mesh))
        return ActResult(*(gather_rows(x, mesh.group("data")) for x in res))

    return act
