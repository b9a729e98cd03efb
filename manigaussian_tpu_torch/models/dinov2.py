"""DINOv2 ViT patch features (port of `manigaussian_tpu/models/dinov2.py`).

The semantic tower of `foundation_model_name='dinov2'` (reference
`dino_extractor.py:10-34`, `neural_rendering.py:149-166`): ImageNet-normalize
the view, the ViT's `forward_features`, `x_norm_patchtokens` (the final
LayerNorm over the patch tokens, CLS and registers dropped), reshape to the
patch grid, bilinear resize to the image.

Architecture (published DINOv2): a p×p conv patch embedding, CLS, the
position embeddings resized bilinearly to the patch grid, optional register
tokens after CLS, pre-norm blocks with LayerScale (GELU MLP ×4), a final
LayerNorm. The parameters carry the torch-hub names (`blocks.{i}.attn.qkv`,
`blocks.{i}.ls1.gamma`, ...), so a facebookresearch/dinov2 state dict loads
as it is. Attention is plain matmul + softmax in the JAX module's order, its
scores divided by √d as a tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from manigaussian_tpu_torch.models.foundation import FeatureExtractor
from manigaussian_tpu_torch.models.sd_vae import load_by_name
from manigaussian_tpu_torch.ops.resize import resize_bilinear
from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        b, n, dim = x.shape
        d = dim // self.heads
        q, k, v = self.qkv(x).split(dim, dim=-1)

        def heads(t):
            return t.reshape(b, n, self.heads, d).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        root_d = torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
        att = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) / root_d, -1)
        o = torch.matmul(att, v).transpose(1, 2).reshape(b, n, dim)
        return self.proj(o)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DinoBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = _Attention(width, heads)
        self.ls1 = _LayerScale(width)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = _Mlp(width)
        self.ls2 = _LayerScale(width)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class DinoV2ViT(nn.Module):
    def __init__(self, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, num_registers: int = 0,
                 pos_grid: int = 37):
        super().__init__()
        self.patch_size, self.width = patch_size, width
        self.num_registers, self.pos_grid = num_registers, pos_grid
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, patch_size,
                                          stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid * pos_grid, width))
        if num_registers:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_registers, width))
        self.blocks = nn.ModuleList(DinoBlock(width, heads)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3], already ImageNet-normalized, H, W multiples
        of the patch → x_norm_patchtokens [B, (H/p)·(W/p), width]."""
        b, h, w, _ = images.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2))   # [B, D, gh, gw]
        x = x.flatten(2).transpose(1, 2)                        # [B, gh·gw, D]
        cls_pos = self.pos_embed[:, :1]
        patch_pos = self.pos_embed[:, 1:].reshape(
            1, self.pos_grid, self.pos_grid, self.width)
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            patch_pos = resize_bilinear(patch_pos, (gh, gw))
        x = x + patch_pos.reshape(1, gh * gw, self.width)
        tokens = [(self.cls_token + cls_pos).expand(b, 1, self.width)]
        if self.num_registers:
            tokens.append(self.register_tokens.expand(
                b, self.num_registers, self.width))
        x = torch.cat(tokens + [x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 1 + self.num_registers:]

    def load_hub(self, sd: Mapping[str, torch.Tensor]) -> "DinoV2ViT":
        """A torch-hub state dict: the built parameters are loaded by name,
        others (`mask_token`) ignored; a missing key raises."""
        return load_by_name(self, sd)


def dims_from_state_dict(sd: Mapping) -> Dict[str, int]:
    d, _, p, _ = sd["patch_embed.proj.weight"].shape
    n_pos = sd["pos_embed"].shape[1] - 1
    layers = max(int(k.split(".")[1]) for k in sd
                 if k.startswith("blocks.")) + 1
    # heads are not in the state dict; published towers use head dim 64
    return dict(patch_size=int(p), width=int(d), layers=layers,
                heads=max(1, int(d) // 64),
                num_registers=(int(sd["register_tokens"].shape[1])
                               if "register_tokens" in sd else 0),
                pos_grid=int(round(np.sqrt(n_pos))))


def load_hub_state_dict(path_or_sd) -> Dict[str, torch.Tensor]:
    """A torch-hub checkpoint file (a state dict, a module, or a dict under
    "model") or a state dict → the state dict."""
    sd = path_or_sd
    if isinstance(path_or_sd, (str, bytes)):
        sd = torch.load(path_or_sd, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd.get("model", sd)


class DinoV2Extractor(FeatureExtractor):
    """The DINOv2 feature provider (JAX `DinoV2JaxExtractor`): [B, H, W, 3]
    in [0, 1] → resize to the smallest multiple of the patch that covers the
    image (140² for 128² at patch 14) → ImageNet normalization →
    x_norm_patchtokens on the patch grid → resized back to [B, H, W, width].
    `checkpoint` is a torch-hub state dict or its file; a converted
    `.msgpack` needs flax and raises (ROADMAP A.6)."""

    def __init__(self, checkpoint, device: DeviceLike = None):
        if isinstance(checkpoint, str) and checkpoint.endswith(".msgpack"):
            raise NotImplementedError(
                "a converted .msgpack DINOv2 needs flax to read; the port "
                "loads the torch-hub state dict itself (reading .msgpack is "
                "ROADMAP A.6, tools/convert_weights)")
        self.device = resolve_device(device)
        sd = load_hub_state_dict(checkpoint)
        dims = dims_from_state_dict(sd)
        self.patch = dims["patch_size"]
        self.model = DinoV2ViT(**dims).load_hub(sd).requires_grad_(
            False).eval().to(self.device)
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = rgb.shape
        p = self.patch
        side = max(((max(h, w) + p - 1) // p) * p, p)
        img = (resize_bilinear(rgb, (side, side)) - self._mean) / self._std
        g = side // p
        feats = self.model(img).reshape(b, g, g, -1)
        return resize_bilinear(feats, (h, w))
