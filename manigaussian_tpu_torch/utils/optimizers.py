"""Reference-exact LAMB, optax's AdamW, the global-norm clip and the
warmup-cosine schedule (port of `manigaussian_tpu/utils/optimizers.py:31-75`
and the optimizer construction of `agents/bc_agent.py:52-72`; reference
`helpers/optim/lamb.py:60-110`).

LAMB as the reference writes it: no bias correction, the weight norm
clamped to [0, 10], the trust ratio 1 when either norm is 0. The trust ratio
is per leaf, so the parameters must be partitioned as the flax tree is, one
tensor per leaf (convert.py maps the trees one to one). On CUDA leaves the
update is the multi-tensor kernel (`ops/fused_lamb.FusedLamb`), on CPU leaves
its plain version (`ops/fused_lamb.lamb_step_reference`). AdamW is
`optax.adamw` (`method.optimizer="adam"`). Both are plain classes with one
interface (`mu`, `nu`, `count`, `step`, `zero_grad`, `state_dict`,
`current_lr`), not `torch.optim` optimizers, whose rounding order and state
layout are not optax's. A state dict names its optimizer (`kind`), and
loading one of the other kind raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from manigaussian_tpu_torch.ops.fused_lamb import (FusedLamb,
                                                   lamb_step_reference)


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps): linear from 0 to `peak`, then a cosine to 0."""
    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        span = max(decay_steps - warmup_steps, 1)
        frac = min(count - warmup_steps, span) / span
        return peak * 0.5 * (1.0 + math.cos(math.pi * frac))
    return lr


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g ← g / ‖g‖ · max_norm when the
    global norm reaches max_norm (decided on the device, no host sync).
    Returns the norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class _Moments:
    """What LAMB and AdamW share: the parameter list, the first and second
    moments, the update count, the learning rate (a float or a schedule of
    the count, read before the count's increment as optax reads it) and the
    state dict."""

    kind = ""

    def __init__(self, params: Iterable[torch.Tensor], lr, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip_norm: float):
        self.params = [p for p in params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def current_lr(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict:
        return {"kind": self.kind,
                "mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu],
                "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        # a state without `kind` was written by LAMB before the field existed
        kind = state.get("kind", "lamb")
        if kind != self.kind:
            raise ValueError(f"optimizer state of {kind!r} cannot be loaded "
                             f"into {self.kind!r} (method.optimizer differs "
                             "from the checkpoint's)")
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        self.count = int(state["count"])


class Lamb(_Moments):
    """Reference LAMB over a list of parameters; `lr` a float or a schedule
    of the update count (optax.inject_hyperparams)."""

    kind = "lamb"

    def __init__(self, params: Iterable[torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0):
        super().__init__(params, lr, b1, b2, eps, weight_decay,
                         grad_clip_norm)
        self._fused: Optional[FusedLamb] = None

    def _kernel(self) -> FusedLamb:
        """The kernel's tables of these leaves, made again if a leaf's
        storage has moved since."""
        if self._fused is None or not self._fused.holds(self.params):
            self._fused = FusedLamb(self.params, self.mu, self.nu)
        return self._fused

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Apply one update from the parameters' `.grad`; returns the global
        gradient norm when clipping is on. CUDA leaves take the kernel, which
        reads a missing gradient as zeros; CPU leaves the plain loop."""
        cuda = self.params[0].is_cuda
        clip = self.grad_clip_norm > 0
        grads = ([p.grad for p in self.params] if cuda and not clip
                 else self._grads())
        norm = clip_by_global_norm_(grads, self.grad_clip_norm) if clip else None
        lr = self.current_lr()
        if cuda:
            self._kernel().step(grads, lr, self.b1, self.b2, self.eps,
                                self.weight_decay)
        else:
            lamb_step_reference(self.params, grads, self.mu, self.nu, lr,
                                self.b1, self.b2, self.eps, self.weight_decay)
        self.count += 1
        return norm


class AdamW(_Moments):
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(lr,
    weight_decay)) with optax's defaults (eps_root 0, decay on every leaf):
    m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², the count incremented, then
    p ← p − lr_t·(m̂ / (√v̂ + eps) + wd·p) with m̂ = m / (1 − b1^count),
    v̂ = v / (1 − b2^count) and lr_t the schedule at the count before the
    increment."""

    kind = "adam"

    def __init__(self, params: Iterable[torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, grad_clip_norm: float = 0.0):
        super().__init__(params, lr, b1, b2, eps, weight_decay,
                         grad_clip_norm)

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Apply one update from the parameters' `.grad`; returns the global
        gradient norm when clipping is on."""
        grads = self._grads()
        norm = None
        if self.grad_clip_norm > 0:
            norm = clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.current_lr()
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        # optax divides the moments by 1 - decay**count, a float32 pow of
        # the float32 decay (0.999 rounds to 0.99900001, so 1 - b2 is 1.3e-5
        # off 1e-3, and an ulp of the power is 2e-5 of 1 - b2**3): numpy's
        # float32 pow rounds as XLA's does. A 0-d tensor keeps the division a
        # true one on CUDA (a Python scalar would become a reciprocal
        # multiply)
        f32 = dict(dtype=torch.float32, device=self.params[0].device)
        c1, c2 = (torch.tensor(1 - np.float32(b) ** np.float32(count), **f32)
                  for b in (b1, b2))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            m_hat = m / c1
            v_hat = v / c2
            u = m_hat / (torch.sqrt(v_hat) + self.eps) + self.weight_decay * p
            p.add_(-lr * u)
        self.count = count
        return norm
