"""Losses of the policy and the splat world model (port of
`manigaussian_tpu/ops/losses.py:19-102`; reference `loss.py:9-73`,
`neural_rendering.py:22-27`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt) * mask)


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
    return psnr_of_mse(torch.mean(torch.square(pred - gt)), max_val)


def psnr_of_mse(mse: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """`psnr` from the batch's MSE (a data-parallel step passes the MSE
    averaged over its ranks)."""
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


def _gaussian_window(window_size: int, sigma: float) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32)
    g = torch.exp(-torch.square(xs - window_size // 2)
                  / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM with an 11×11 Gaussian window (σ 1.5, the outer product of
    the 1-D window), images [B, H, W, C] channels-last as in the JAX
    package; a depthwise conv with zero padding of window_size // 2 (the
    reference's F.conv2d(padding=k//2) on NCHW)."""
    g = _gaussian_window(window_size, 1.5).to(img1.device)
    c = img1.shape[-1]
    window = torch.outer(g, g).expand(c, 1, window_size, window_size)

    def dconv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), window.to(x.dtype),
                        padding=window_size // 2, groups=c)

    mu1, mu2 = dconv(img1), dconv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = dconv(img1 * img1) - mu1_sq
    sigma2_sq = dconv(img2 * img2) - mu2_sq
    sigma12 = dconv(img1 * img2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def softmax_cross_entropy_with_onehot(logits: torch.Tensor,
                                      labels_onehot: torch.Tensor
                                      ) -> torch.Tensor:
    """Mean CE over the batch with one-hot labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels_onehot * logp, dim=-1))
