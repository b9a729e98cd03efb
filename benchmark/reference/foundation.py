"""The semantic tiers' ground-truth embedding, plain PyTorch: a frozen copy
of the port's `models/foundation.py` SD VAE route. The tower reads the
target view resized to 512², normalized to [-1, 1], encodes it, decodes the
clean latent to the last decoder tap ([B, 512, 128, 128]), resizes that
back to the view; a per-image randomized PCA then keeps `d_embed`
channels. With `random-init` the tower's weights come from a CPU generator
seeded `SEED`, as the port draws them.
"""

from __future__ import annotations

import torch

from .resize import resize_bilinear
from .sd_vae import SDVae

# the input size of the SD VAE (ODISE's diffusion_preprocess resize)
FEATURE_HW = 512
# seed of the PCA's random test matrix and of the random-init SD VAE
SEED = 0


def pca_omega(c: int, q: int) -> torch.Tensor:
    """The randomized PCA's test matrix Ω [c, q], standard normal, drawn on
    the CPU from a generator seeded `SEED`."""
    return torch.randn((c, q), generator=torch.Generator().manual_seed(SEED))


def pca_lowrank_v(features: torch.Tensor, q: int = 6) -> torch.Tensor:
    """Right singular vectors V [..., C, q] of the centred features
    [..., HW, C] by randomized SVD (torch.pca_lowrank's algorithm, niter 2):
    QR iterations on A·Ω, then a small SVD. Ω is `pca_omega`'s, one for
    every image of a batch, as JAX's vmap uses one key. Two iterations do not
    converge on a flat spectrum (the SD VAE's random-weight features), so
    there the result depends on Ω, in JAX as here."""
    hw, c = features.shape[-2:]
    q = min(q, hw, c)
    a = features - features.mean(dim=-2, keepdim=True)
    omega = pca_omega(c, q).to(features)
    at = a.transpose(-2, -1)
    qmat, _ = torch.linalg.qr(a @ omega)
    for _ in range(2):
        qh, _ = torch.linalg.qr(at @ qmat)
        qmat, _ = torch.linalg.qr(a @ qh)
    b = qmat.transpose(-2, -1) @ a                          # [..., q, C]
    _u, _s, vh = torch.linalg.svd(b, full_matrices=False)
    return vh.transpose(-2, -1)


def pca_to_channels(features: torch.Tensor, d_embed: int = 3,
                    method: str = "lowrank") -> torch.Tensor:
    """[..., HW, C] → [..., HW, d_embed]: the uncentred features projected
    on the top right singular vectors of the centred ones (A @ V[:, :d]), as
    neural_rendering.py:159-162. `method` 'lowrank' (randomized, q =
    max(6, d_embed)) or 'exact' (full SVD)."""
    if method == "lowrank":
        v = pca_lowrank_v(features, q=max(6, d_embed))[..., :d_embed]
    elif method == "exact":
        centred = features - features.mean(dim=-2, keepdim=True)
        _u, _s, vh = torch.linalg.svd(centred, full_matrices=False)
        v = vh.transpose(-2, -1)[..., :d_embed]
    else:
        raise ValueError(f"unknown PCA method {method!r}")
    return features @ v


def pca_to_channels_batch(features: torch.Tensor, d_embed: int = 3,
                          method: str = "lowrank") -> torch.Tensor:
    """[B, HW, C] → [B, HW, d_embed], one PCA per image."""
    return pca_to_channels(features, d_embed, method=method)


def sd_vae_tower(device) -> SDVae:
    """The random-init tower, frozen, on `device`."""
    model = SDVae().init_params(torch.Generator().manual_seed(SEED))
    return model.requires_grad_(False).eval().to(device)


@torch.no_grad()
def gt_embed(tower: SDVae, rgb: torch.Tensor, d_embed: int = 3) -> torch.Tensor:
    """rgb [B, H, W, 3] in [0, 1] → GT embedding [B, H, W, d_embed]."""
    b, h, w = rgb.shape[:3]
    feature_hw = FEATURE_HW
    img = resize_bilinear(rgb, (feature_hw, feature_hw))
    out = tower((img * 2.0 - 1.0).permute(0, 3, 1, 2))
    feats = resize_bilinear(out["decoder_features"][-1].permute(0, 2, 3, 1),
                            (h, w))
    c = feats.shape[-1]
    proj = pca_to_channels_batch(feats.reshape(b, h * w, c), d_embed)
    return proj.reshape(b, h, w, d_embed)
