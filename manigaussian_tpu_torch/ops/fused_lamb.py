"""Multi-tensor LAMB: the wrapper of the CUDA kernel (`csrc/lamb.cu`), the
table of work it walks, and its plain PyTorch version.

The kernel replaces no TPU kernel: the JAX package's LAMB is jnp that XLA
fuses under `jit`, while the plain version here, run eagerly on CUDA, costs
about 25 launches a leaf. Its bound and design are noted in the source.

`FusedLamb` holds, for a list of float32 CUDA leaves and their moments, the
device tables the kernel reads: the leaf table (the addresses of p, m and v,
the leaf's first work item and count) and the work table (`work_items`: each
leaf cut into chunks of CHUNK elements, in leaf order), built once from the
leaves' shapes and built again if a leaf's storage moves. `step` launches the
kernel's two passes once for each group of at most LEAVES_PER_LAUNCH leaves
(`launch_groups`: one group at every configuration the port runs), with the
gradients' addresses passed by value; a leaf without a gradient reads as
zeros. It neither copies to the device nor synchronises. It raises on what
the kernel does not take (another device, another dtype, a non-contiguous
tensor) and never falls back. `utils/optimizers.Lamb.step` takes it for CUDA
leaves and `lamb_step_reference` for CPU ones.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from manigaussian_tpu_torch.ops import _cuda

CHUNK = 8192              # elements of a work item
LEAVES_PER_LAUNCH = 256   # gradient addresses a launch carries (csrc/lamb.cu kMaxLeaves)


@torch.no_grad()
def lamb_step_reference(params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                        lr: float, b1: float, b2: float, eps: float,
                        weight_decay: float) -> None:
    """The plain version, in place, leaf by leaf (reference
    `helpers/optim/lamb.py:60-110`): no bias correction, the weight norm
    clamped to [0, 10], the trust ratio 1 when either norm is 0."""
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = m / (torch.sqrt(v) + eps)
        if weight_decay != 0.0:
            step = step + weight_decay * p
        w_norm = torch.clamp(torch.linalg.norm(p.reshape(-1)), 0.0, 10.0)
        a_norm = torch.linalg.norm(step.reshape(-1))
        trust = torch.where((w_norm == 0.0) | (a_norm == 0.0),
                            torch.ones_like(w_norm),
                            w_norm / torch.clamp(a_norm, min=1e-30))
        p.add_((-lr * trust) * step)


def work_items(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """int64 [n, 3] rows (leaf, start, length): each leaf cut into chunks of
    `chunk` elements in order, its last one ragged, the leaves in order; a
    leaf of no element has none."""
    rows = [(leaf, start, min(chunk, n - start))
            for leaf, n in enumerate(numels) for start in range(0, n, chunk)]
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


def leaf_spans(items: np.ndarray, n_leaves: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first, count): each leaf's first row in `items` and its rows."""
    count = np.bincount(items[:, 0], minlength=n_leaves).astype(np.int64)
    return np.cumsum(count) - count, count


def launch_groups(n_leaves: int,
                  per_launch: int = LEAVES_PER_LAUNCH) -> List[Tuple[int, int]]:
    """[(lo, hi)]: the leaves each launch takes, in order."""
    return [(lo, min(lo + per_launch, n_leaves))
            for lo in range(0, n_leaves, per_launch)]


def check_leaf(name: str, t: torch.Tensor, device: torch.device,
               shape: Optional[torch.Size] = None) -> None:
    """Raise unless `t` is a contiguous float32 tensor on `device` (of
    `shape` when given): what the kernel takes."""
    if (t.device != device or t.dtype != torch.float32
            or not t.is_contiguous()
            or (shape is not None and t.shape != shape)):
        want = f" {tuple(shape)}" if shape is not None else ""
        layout = "" if t.is_contiguous() else " non-contiguous"
        raise ValueError(f"the LAMB kernel takes contiguous float32{want} "
                         f"tensors on {device}; {name} is a{layout} {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _library() -> ctypes.CDLL:
    lib = _cuda.load("lamb")
    if lib.lamb_step.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lamb_step.argtypes = ([ptr, ptr, i32, ctypes.POINTER(ptr), i32, ptr]
                                  + [f32] * 6 + [i32, f32, ptr])
        lib.lamb_step.restype = i32
    return lib


class FusedLamb:
    """The kernel's tables for one optimizer's leaves; `step` is one update
    of them in place."""

    launches = 0   # kernel launches, over every instance

    def __init__(self, params: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]):
        if not params or not len(params) == len(mu) == len(nu):
            raise ValueError(f"the LAMB kernel takes one moment pair a leaf, "
                             f"got {len(params)} leaves, {len(mu)} and "
                             f"{len(nu)} moments")
        device = params[0].device
        if device.type != "cuda":
            raise ValueError(f"the LAMB kernel takes CUDA tensors, got {device}")
        for i, (p, m, v) in enumerate(zip(params, mu, nu)):
            check_leaf(f"leaf {i}", p, device)
            check_leaf(f"leaf {i}'s first moment", m, device, p.shape)
            check_leaf(f"leaf {i}'s second moment", v, device, p.shape)
        self.device = device
        self.shapes = [p.shape for p in params]
        self.addresses = [p.data_ptr() for p in params]
        self.groups = []   # (lo, hi, leaf table, work table, partials)
        for lo, hi in launch_groups(len(params)):
            items = work_items([p.numel() for p in params[lo:hi]])
            if not len(items):
                continue
            first, count = leaf_spans(items, hi - lo)
            table = np.array([[p.data_ptr(), m.data_ptr(), v.data_ptr()]
                              for p, m, v in zip(params[lo:hi], mu[lo:hi],
                                                 nu[lo:hi])], dtype=np.int64)
            leaves = np.concatenate([table, first[:, None], count[:, None]], 1)
            self.groups.append((
                lo, hi, torch.from_numpy(leaves).to(device),
                torch.from_numpy(items).to(device),
                torch.empty(len(items), 2, dtype=torch.float32, device=device)))

    def holds(self, params: Sequence[torch.Tensor]) -> bool:
        """Whether the tables still point at these leaves' storage (the
        moments are the optimizer's own, only ever written in place)."""
        return [p.data_ptr() for p in params] == self.addresses

    def step(self, grads: Sequence[Optional[torch.Tensor]], lr: float,
             b1: float, b2: float, eps: float, weight_decay: float) -> None:
        """One LAMB update of the leaves from `grads` (None: zeros), with
        the plain version's float32 constants."""
        if len(grads) != len(self.shapes):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.shapes)} leaves")
        for i, (g, shape) in enumerate(zip(grads, self.shapes)):
            if g is not None:
                check_leaf(f"leaf {i}'s gradient", g, self.device, shape)
        lib = _library()
        coeffs = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
                  weight_decay != 0.0, -lr)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            for lo, hi, leaves, items, partials in self.groups:
                gp = (ctypes.c_void_p * (hi - lo))(
                    *(None if g is None else g.data_ptr() for g in grads[lo:hi]))
                err = lib.lamb_step(leaves.data_ptr(), items.data_ptr(),
                                    items.shape[0], gp, hi - lo,
                                    partials.data_ptr(), *coeffs, stream)
                if err:
                    raise RuntimeError(f"LAMB kernel launch failed: CUDA error {err}")
                FusedLamb.launches += 2
