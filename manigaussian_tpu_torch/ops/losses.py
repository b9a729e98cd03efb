"""Losses of the policy and the splat world model (port of
`manigaussian_tpu/ops/losses.py:19-102`; reference `loss.py:9-73`,
`neural_rendering.py:22-27`)."""

from __future__ import annotations

import torch


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - gt))


def cosine_loss(pred: torch.Tensor, gt: torch.Tensor,
                eps: float = 1e-4) -> torch.Tensor:
    """1 - mean cosine similarity along the last axis, with the JAX
    package's smooth norm sqrt(‖x‖² + eps²): rendered embeddings are exactly
    zero where nothing splats, and a clamped norm there gives ~1/eps-scale
    gradients."""
    pn = torch.sqrt((pred * pred).sum(dim=-1) + eps * eps)
    gn = torch.sqrt((gt * gt).sum(dim=-1) + eps * eps)
    return 1.0 - torch.mean((pred * gt).sum(dim=-1) / (pn * gn))


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Scalar PSNR over the whole batch; 100 when the MSE is 0."""
    mse = torch.mean(torch.square(pred - gt))
    mse_safe = torch.where(mse == 0, torch.ones_like(mse), mse)
    val = 20.0 * torch.log10(max_val / torch.sqrt(mse_safe))
    return torch.where(mse == 0, torch.full_like(mse, 100.0), val)


def softmax_cross_entropy_with_index(logits: torch.Tensor,
                                     label_idx: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch with integer labels (the `_celoss` of the
    trans/rot/grip/collision heads, qattention:614-615)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, label_idx.long()[..., None])[..., 0]
    return -torch.mean(picked)
