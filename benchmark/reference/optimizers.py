"""The reference LAMB, plain PyTorch: a frozen copy of the port's
`utils/optimizers.Lamb`. No bias correction, the weight norm clamped to
[0, 10], the trust ratio 1 when either norm is 0, per leaf; the global-norm
clip when `grad_clip_norm` > 0.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Lamb:
    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(grads, self.grad_clip_norm)
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
            p.add_((-self.lr * trust) * step)
