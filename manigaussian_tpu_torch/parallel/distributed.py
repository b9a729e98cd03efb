"""Multi-process wiring: the rendezvous, the backend, and the collectives of
the sharded step (counterpart of `manigaussian_tpu/parallel/distributed.py`).

One process drives one rank. `init_distributed` takes the JAX CLI's
`host:port,nprocs,pid` spec and joins a `torch.distributed` group through a
TCP store. The backend: NCCL when every rank has a GPU of its own, gloo on
the CPU, and gloo on request when ranks share a card (NCCL refuses two ranks
on one GPU: such a start raises and says so; it does not switch backend).

Every collective here is built on `all_reduce`, so one code path serves
NCCL and gloo on CPU and CUDA tensors alike (gloo takes CUDA tensors only
in `all_reduce` and `broadcast`). `gather_rows` is an all-gather made exact
as the sum of zero-filled full tensors, each rank's rows in its place.

Two autograd functions carry the tile group's gradients (the autograd form
of what `shard_map` does in the JAX renderer): `replicate` is the identity
forward and sums the gradient over the group on the way back (each rank's
tiles give a part of every Gaussian's gradient); `gather_patches`
concatenates the ranks' patches forward and passes back only the rank's own
slice of the gradient (every rank computes the same replicated loss, so a
reduce-scatter would count that gradient once per rank).

Data convention ("replicated iterator"): every rank samples the identical
global batch from an identically seeded iterator and keeps its own rows
(`global_batch`); every random draw of the step is made for the global batch
and sliced the same way, so the sharded step equals the one-process step.
For disjoint data instead, each rank samples from `disjoint_replay` (a
`TaskUniformReplay(shard=(rank, n))`) and its local batch is already its
rows (`local_batch_to_global`).

`count_collective_bytes()` counts, while its block runs, the output bytes of
every logical collective above under the names of the JAX HLO count
(`bench_scaling.py`): "all-reduce" (`all_reduce`, `flat_all_reduce`, and so
`replicate`'s backward) and "all-gather" (`gather_rows`, and so
`gather_patches`, though gloo runs it as an all-reduce of zero-filled full
tensors). Outside such a block nothing is counted.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def parse_spec(spec: str) -> Tuple[str, int, int, int]:
    """'host:port,nprocs,pid' → (host, port, world size, rank)."""
    address, nprocs, pid = spec.split(",")
    host, port = address.rsplit(":", 1)
    world, rank = int(nprocs), int(pid)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    return host, int(port), world, rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_of(device: torch.device) -> str:
    return f"{socket.gethostname()}/cuda:{device.index}"


def init_distributed(spec: str, device: str = "cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group named by `spec`; returns this rank's device.

    `device` "cpu" runs the rank on the CPU over gloo. "cuda" takes GPU
    rank % (GPUs on the host) (ranks are numbered host by host) and NCCL,
    unless `backend` is "gloo"; ranks that share a card must ask for gloo,
    NCCL on a shared card raises before any collective."""
    host, port, world, rank = parse_spec(spec)
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu to "
                               "run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    store = dist.TCPStore(host, port, world, is_master=rank == 0,
                          timeout=TIMEOUT)
    if dev.type == "cuda":
        store.set(f"card{rank}", _card_of(dev))
        cards = [store.get(f"card{r}").decode() for r in range(world)]
        shared = len(set(cards)) < world
        if shared and backend == "nccl":
            raise RuntimeError(
                f"ranks share a GPU ({cards}): NCCL refuses two ranks on one "
                "card; ask for the gloo backend (--backend gloo) to run them "
                "there")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute")
_counts: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def count_collective_bytes():
    """Yields a dict (COLLECTIVES → bytes) to which every collective of
    this process adds its output's bytes until the block ends; the
    autograd functions' backwards count too, on whatever thread runs them.
    Blocks nest: the inner one counts alone."""
    global _counts
    outer, _counts = _counts, dict.fromkeys(COLLECTIVES, 0)
    try:
        yield _counts
    finally:
        _counts = outer


def _count(kind: str, t: torch.Tensor) -> None:
    if _counts is not None:
        _counts[kind] += t.numel() * t.element_size()


def _reduce_(t: torch.Tensor, op: str, group) -> torch.Tensor:
    _count("all-reduce", t)
    dist.all_reduce(t, op=_OPS[op], group=group)
    if op == "mean":
        t /= dist.get_world_size(group)
    return t


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A reduced copy of `t` over `group` ("sum", "mean", "min", "max");
    `t` itself is left as it is. "mean" is the sum divided by the group's
    size."""
    return _reduce_(t.detach().clone().contiguous(), op, group)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's `t` (equal shapes) along dim 0, in the
    group's rank order: the sum of zero-filled full tensors, each holding
    one rank's rows (exact: every element is one value plus zeros)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    full = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
    full[i * t.shape[0]:(i + 1) * t.shape[0]] = t.detach()
    _count("all-gather", full)
    dist.all_reduce(full, group=group)
    return full


def flat_all_reduce(tensors: Sequence[torch.Tensor], op: str = "sum",
                    group=None) -> List[torch.Tensor]:
    """One all-reduce of `tensors` packed into a flat float32 buffer, in
    their order; returns the reduced tensors in their own dtypes."""
    flat = _reduce_(torch.cat([t.detach().reshape(-1).float()
                               for t in tensors]), op, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):   # an unused output's gradient comes as zeros
        need = ctx.needs_input_grad[1:]
        summed = iter(flat_all_reduce([g for g, n in zip(grads, need) if n],
                                      "sum", ctx.group))
        return (None,) + tuple(next(summed) if n else None for n in need)


def replicate(group, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The identity on tensors every rank of `group` holds alike; the
    gradients of those that need one are summed over the group (one
    all-reduce for all of them)."""
    return _Replicate.apply(group, *xs)


class _GatherPatches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, anchor):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        shape, dtype, device = ctx.anchor
        return (g[i * ctx.rows:(i + 1) * ctx.rows].contiguous(), None,
                torch.zeros(shape, dtype=dtype, device=device))


def gather_patches(x: torch.Tensor, group, anchor: torch.Tensor
                   ) -> torch.Tensor:
    """`gather_rows` whose gradient is the rank's own rows of the output's
    gradient (the loss after it is the same on every rank of the group).
    `anchor`, a tensor of the graph before the rank's own work (the output
    of `replicate`), gets a zero gradient: the output needs a gradient, and
    the backward reaches `replicate`'s collective, on every rank of the
    group alike, also where the rank's patches carry no graph (a window
    with no splats in the plain blend)."""
    return _GatherPatches.apply(x, group, anchor)


# ------------------------------------------------------------ the batches
def global_batch(batch: Dict, mesh, axis: str = "data") -> Dict:
    """This rank's rows of the identical global batch every rank holds:
    rows index·b … (index+1)·b − 1 of each leaf, b = global / size(axis).
    Lists (strings, object arrays) are sliced alike."""
    n, i = mesh.size(axis), mesh.index(axis)

    def rows(x):
        total = len(x)
        if total % n:
            raise ValueError(f"global batch {total} does not divide by the "
                             f"{n} ranks of the {axis!r} axis")
        b = total // n
        return x[i * b:(i + 1) * b]

    return {k: rows(v) for k, v in batch.items()}


def disjoint_replay(mesh, save_dir: Optional[str] = None, axis: str = "data"):
    """Disjoint-data mode: a replay of every n-th transition of each task
    (reference `task_uniform_replay_buffer.py:113-118`), n the ranks of
    `axis`; each rank samples its own local batch from it."""
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    return TaskUniformReplay(save_dir=save_dir,
                             shard=(mesh.index(axis), mesh.size(axis)))


def local_batch_to_global(local: Dict, mesh, global_batch_size: int,
                          axis: str = "data") -> Dict:
    """Disjoint-data mode: a rank's local batch, sampled from its
    `disjoint_replay`, already is its rows of the global batch; checked
    against the global size and returned as it is (rows in mesh order)."""
    n = mesh.size(axis)
    for k, v in local.items():
        if len(v) * n != global_batch_size:
            raise ValueError(f"{k}: {len(v)} local rows × {n} ranks is not "
                             f"the global batch {global_batch_size}")
    return local


def params_in_sync(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """Whether every rank holds these tensors bit for bit alike: their
    element-wise max and min over the group are equal (the same answer on
    every rank)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return torch.equal(all_reduce(flat, "max", group),
                       all_reduce(flat, "min", group))


def spawn_local(fn, world: int, args: tuple = ()) -> None:
    """Start `world` local processes running fn(rank, port, *args), rank 0…
    world − 1, on a localhost rendezvous (`torch.multiprocessing`, spawn);
    returns when all have ended, raises if one failed."""
    import torch.multiprocessing as mp
    port = free_port()
    # ranks on the CPU share its cores (each would take them all)
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 2)
                                                     // max(1, world))))
    mp.start_processes(fn, args=(port,) + tuple(args), nprocs=world,
                       join=True, start_method="spawn")


def dist_spec(port: int, world: int, pid: int, host: str = "localhost") -> str:
    """The `host:port,nprocs,pid` spec of `init_distributed`."""
    return f"{host}:{port},{world},{pid}"


class Rows(NamedTuple):
    """Where a rank's rows sit in the global batch: its first row and the
    global batch size."""
    lo: int
    total: int


def global_draw(draw: Callable[[int], torch.Tensor], b: int,
                rows: Optional[Rows], dim: int = 0) -> torch.Tensor:
    """A random draw of a step for the rank's `b` rows: draw(n) makes it
    for n rows along `dim`; with `rows`, for the global batch, of which the
    rank's rows are kept (so the generator advances as in the one-process
    step and every rank draws what that step draws on its rows)."""
    if rows is None:
        return draw(b)
    return draw(rows.total).narrow(dim, rows.lo, b)
