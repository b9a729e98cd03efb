"""Reference-exact LAMB, the global-norm clip and the warmup-cosine schedule
(port of `manigaussian_tpu/utils/optimizers.py:31-75` and the optimizer
construction of `agents/bc_agent.py:52-72`; reference
`helpers/optim/lamb.py:60-110`).

LAMB as the reference writes it: no bias correction, the weight norm
clamped to [0, 10], the trust ratio 1 when either norm is 0. The trust ratio
is per leaf, so the parameters must be partitioned as the flax tree is, one
tensor per leaf (convert.py maps the trees one to one). A plain class, not a
`torch.optim` LAMB.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch


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


class Lamb:
    """Reference LAMB over a list of parameters; `lr` a float or a schedule
    of the update count (optax.inject_hyperparams)."""

    def __init__(self, params: Iterable[torch.Tensor], lr, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0):
        self.params = [p for p in params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def current_lr(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """Apply one update from the parameters' `.grad`; returns the global
        gradient norm when clipping is on."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = None
        if self.grad_clip_norm > 0:
            norm = clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.current_lr()
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            step = m / (torch.sqrt(v) + self.eps)
            if self.weight_decay != 0.0:
                step = step + self.weight_decay * p
            w_norm = torch.clamp(torch.linalg.norm(p.reshape(-1)), 0.0, 10.0)
            a_norm = torch.linalg.norm(step.reshape(-1))
            trust = torch.where((w_norm == 0.0) | (a_norm == 0.0),
                                torch.ones_like(w_norm),
                                w_norm / torch.clamp(a_norm, min=1e-30))
            p.add_((-lr * trust) * step)
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict:
        return {"mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu],
                "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        self.count = int(state["count"])
