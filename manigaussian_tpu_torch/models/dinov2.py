"""DINOv2 ViT patch features (port of `manigaussian_tpu/models/dinov2.py`).

The semantic tower of `foundation_model_name='dinov2'` (reference
`dino_extractor.py:10-34`, `neural_rendering.py:149-166`): ImageNet-normalize
the view, the ViT's `forward_features`, `x_norm_patchtokens` (the final
LayerNorm over the patch tokens, CLS and registers dropped), reshape to the
patch grid, bilinear resize to the image.

Architecture (published DINOv2): a p×p conv patch embedding, CLS, the
position embeddings resized bilinearly to the patch grid, optional register
tokens after CLS, pre-norm blocks with LayerScale (an MLP of `mlp_ratio` ×
width through the config's activation, or the SwiGLU MLP of the giant
model), a final LayerNorm. The parameters carry the torch-hub names
(`blocks.{i}.attn.qkv`, `blocks.{i}.ls1.gamma`, ...), so a
facebookresearch/dinov2 state dict loads as it is. Attention is plain matmul + softmax in the JAX module's order, its
scores divided by √d as a tensor.

A local Hugging Face DINOv2 directory (`config.json`,
`preprocessor_config.json`, `pytorch_model.bin` or `model.safetensors`) loads
without `transformers` (`DinoV2DirExtractor`, the JAX package's
`DINOv2FeatureExtractor`): the weights are renamed to the torch-hub names
(`hub_from_hf`), safetensors files are read and written here
(`read_safetensors`, `write_safetensors`; `read_hf_weights` picks a
directory's weights file, also for `tools/convert_weights t5`), and the
image processor's steps are copied (`HFImageProcessor`): each image
quantized to uint8 and resized by PIL as `transformers` does,
centre-cropped, ImageNet-normalized in float32 on the host; the position
embeddings are resized bicubically, as the HF model does.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Tuple

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


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * torch.pow(x, 3.0))))


# `hidden_act` of a DINOv2 config → what `transformers`' ACT2FN computes
ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_new": _gelu_new,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
}


def activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"DINOv2 hidden_act {name!r} is not one of "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def swiglu_hidden(width: int, mlp_ratio: float) -> int:
    """The SwiGLU MLP's hidden width (torch-hub `SwiGLUFFNFused`,
    `transformers`' `Dinov2SwiGLUFFN`): two thirds of width · mlp_ratio,
    rounded up to a multiple of 8."""
    return (int(int(width * mlp_ratio) * 2 / 3) + 7) // 8 * 8


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int, act: str = "gelu"):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)
        self.act = activation(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _SwiGLU(nn.Module):
    """w3(silu(x1) · x2), where x1, x2 = chunk(w12(x), 2) (torch-hub names
    `mlp.w12` / `mlp.w3`; HF's `weights_in` / `weights_out`)."""

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(width, 2 * hidden)
        self.w3 = nn.Linear(hidden, width)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class DinoBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 eps: float = LN_EPS, act: str = "gelu",
                 swiglu: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=eps)
        self.attn = _Attention(width, heads)
        self.ls1 = _LayerScale(width)
        self.norm2 = nn.LayerNorm(width, eps=eps)
        # under SwiGLU the activation is SiLU whatever `act` says, as in
        # transformers, which ignores hidden_act there
        self.mlp = (_SwiGLU(width, swiglu_hidden(width, mlp_ratio)) if swiglu
                    else _Mlp(width, int(width * mlp_ratio), act))
        self.ls2 = _LayerScale(width)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class DinoV2ViT(nn.Module):
    """`pos_resize`: how the position grid is resized to the patch grid,
    "bilinear" as `jax.image.resize` (the JAX module) or "bicubic" as the
    HF model (`F.interpolate`, no antialias). `act` names the MLP's
    activation (`ACTIVATIONS`); `swiglu` takes the SwiGLU MLP instead."""

    def __init__(self, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, num_registers: int = 0,
                 pos_grid: int = 37, mlp_ratio: float = 4.0,
                 eps: float = LN_EPS, pos_resize: str = "bilinear",
                 act: str = "gelu", swiglu: bool = False):
        super().__init__()
        self.patch_size, self.width = patch_size, width
        self.num_registers, self.pos_grid = num_registers, pos_grid
        self.pos_resize = pos_resize
        self.mlp_ratio, self.act, self.swiglu = mlp_ratio, act, swiglu
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, patch_size,
                                          stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid * pos_grid, width))
        if num_registers:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_registers, width))
        self.blocks = nn.ModuleList(DinoBlock(width, heads, mlp_ratio, eps,
                                              act, swiglu)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(width, eps=eps)

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
            if self.pos_resize == "bicubic":
                patch_pos = F.interpolate(
                    patch_pos.permute(0, 3, 1, 2), size=(gh, gw),
                    mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
            else:
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
    `checkpoint` is a torch-hub state dict or its file, or a `.msgpack` of
    `tools/convert_weights dinov2` (either package's)."""

    def __init__(self, checkpoint, device: DeviceLike = None):
        self.device = resolve_device(device)
        if isinstance(checkpoint, str) and checkpoint.endswith(".msgpack"):
            from manigaussian_tpu_torch.convert import dinov2_state_dict
            from manigaussian_tpu_torch.tools.convert_weights import \
                load_converted
            payload = load_converted(checkpoint)
            dims, sd = payload["dims"], dinov2_state_dict(
                payload["variables"])
        else:
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


# ------------------------------------------- the Hugging Face directory
SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
                      "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64, "I32": torch.int32,
                      "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                      "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file: an 8-byte little-endian header length, a JSON
    header (name → dtype, shape, data_offsets into the data), then the raw
    little-endian tensors."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        dt = SAFETENSORS_DTYPES[info["dtype"]]
        t = (torch.frombuffer(bytearray(data[base + lo:base + hi]), dtype=dt)
             if hi > lo else torch.empty(0, dtype=dt))
        out[name] = t.reshape(info["shape"])
    return out


def read_hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """A Hugging Face directory's torch weights, in transformers' order of
    preference: model.safetensors (read here), then pytorch_model.bin."""
    st = os.path.join(path, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {path}")


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """The inverse of `read_safetensors` (names in sorted order, the header
    padded with spaces to a multiple of 8 bytes)."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, at = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(blob)]}
        blobs.append(blob)
        at += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _hf_layer_names(i: int) -> Dict[str, str]:
    """Torch-hub name → HF name of block i's tensors (q, k, v apart)."""
    hf, hub = f"encoder.layer.{i}.", f"blocks.{i}."
    pairs = {"norm1": "norm1", "norm2": "norm2", "attn.proj":
             "attention.output.dense", "mlp.fc1": "mlp.fc1",
             "mlp.fc2": "mlp.fc2", "mlp.w12": "mlp.weights_in",
             "mlp.w3": "mlp.weights_out"}
    out = {hub + a + s: hf + b + s for a, b in pairs.items()
           for s in (".weight", ".bias")}
    out[hub + "ls1.gamma"] = hf + "layer_scale1.lambda1"
    out[hub + "ls2.gamma"] = hf + "layer_scale2.lambda1"
    return out


_HF_TOP = {"cls_token": "embeddings.cls_token",
           "pos_embed": "embeddings.position_embeddings",
           "register_tokens": "embeddings.register_tokens",
           "patch_embed.proj.weight": "embeddings.patch_embeddings.projection.weight",
           "patch_embed.proj.bias": "embeddings.patch_embeddings.projection.bias",
           "norm.weight": "layernorm.weight", "norm.bias": "layernorm.bias"}


def hub_from_hf(sd: Mapping[str, torch.Tensor], layers: int
                ) -> Dict[str, torch.Tensor]:
    """An HF `Dinov2Model` state dict (with or without the `dinov2.` prefix
    of the task heads) → torch-hub names: q, k and v concatenated into
    `attn.qkv`; the mask token and any head left out."""
    sd = {k[len("dinov2."):] if k.startswith("dinov2.") else k: v
          for k, v in sd.items()}
    hub = {a: sd[b] for a, b in _HF_TOP.items() if b in sd}
    for i in range(layers):
        hub.update({a: sd[b] for a, b in _hf_layer_names(i).items()
                    if b in sd})
        att = f"encoder.layer.{i}.attention.attention."
        for s in ("weight", "bias"):
            hub[f"blocks.{i}.attn.qkv.{s}"] = torch.cat(
                [sd[att + f"{x}.{s}"] for x in ("query", "key", "value")])
    return hub


def hf_from_hub(hub: Mapping[str, torch.Tensor], layers: int
                ) -> Dict[str, torch.Tensor]:
    """The inverse of `hub_from_hf` (the writer of `save_hf_dir`)."""
    sd = {b: hub[a] for a, b in _HF_TOP.items() if a in hub}
    for i in range(layers):
        sd.update({b: hub[a] for a, b in _hf_layer_names(i).items()
                   if a in hub})
        att = f"encoder.layer.{i}.attention.attention."
        for s in ("weight", "bias"):
            q, k, v = hub[f"blocks.{i}.attn.qkv.{s}"].chunk(3)
            sd.update({att + f"query.{s}": q, att + f"key.{s}": k,
                       att + f"value.{s}": v})
    return sd


def save_hf_dir(path: str, model: DinoV2ViT, size: Dict = None,
                crop_size: Dict = None) -> None:
    """Write `model` as a Hugging Face DINOv2 directory: config.json (its
    MLP's ratio and activation, SwiGLU or not), preprocessor_config.json (a
    BitImageProcessor's: resize the short side to `size`, bicubic, centre
    crop to `crop_size`, ImageNet mean and std) and model.safetensors."""
    os.makedirs(path, exist_ok=True)
    config = {"model_type": "dinov2", "architectures": ["Dinov2Model"],
              "hidden_size": model.width,
              "num_hidden_layers": len(model.blocks),
              "num_attention_heads": model.blocks[0].attn.heads,
              "mlp_ratio": model.mlp_ratio, "patch_size": model.patch_size,
              "image_size": model.pos_grid * model.patch_size,
              "layer_norm_eps": model.norm.eps, "hidden_act": model.act,
              "qkv_bias": True, "use_swiglu_ffn": model.swiglu,
              "num_channels": 3, "layerscale_value": 1.0}
    proc = {"image_processor_type": "BitImageProcessor", "do_resize": True,
            "size": size or {"shortest_edge": 256}, "resample": 3,
            "do_center_crop": True,
            "crop_size": crop_size or {"height": 224, "width": 224},
            "do_rescale": True, "rescale_factor": 1 / 255,
            "do_normalize": True, "image_mean": list(IMAGENET_MEAN),
            "image_std": list(IMAGENET_STD), "do_convert_rgb": True}
    for name, obj in (("config.json", config),
                      ("preprocessor_config.json", proc)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f, indent=1)
    hub = {k: v for k, v in model.state_dict().items()}
    write_safetensors(os.path.join(path, "model.safetensors"),
                      hf_from_hub(hub, len(model.blocks)))


class HFImageProcessor:
    """The steps of the `BitImageProcessor` a DINOv2 directory names, called
    as the JAX extractor calls it (`do_rescale=False`, float images in
    [0, 1]), each as `transformers` computes it on the host: the resize of
    `transformers.image_transforms.resize` (the image scaled by 255 in
    float64, cast to float32, truncated to uint8, resized by PIL with the
    config's filter, scaled back by 1/255 in float64 to float32; an image
    of whole numbers is taken as 0-255 and not scaled), the centre crop
    (zero padding where the crop is larger), then (x − mean) / std in
    float32."""

    def __init__(self, config: Mapping):
        self.cfg = dict(config)

    def _out_size(self, h: int, w: int) -> Tuple[int, int]:
        size = self.cfg.get("size", {"shortest_edge": 224})
        if "shortest_edge" in size:
            short, long = (w, h) if w <= h else (h, w)
            new_short = int(size["shortest_edge"])
            new_long = int(new_short * long / short)
            return (new_long, new_short) if w <= h else (new_short, new_long)
        return int(size["height"]), int(size["width"])

    def _resize(self, img: np.ndarray) -> np.ndarray:
        from PIL import Image
        h, w = self._out_size(*img.shape[:2])
        if img.dtype == np.uint8:
            rescale = False
        elif np.allclose(img, img.astype(int)):
            if img.min() < 0 or img.max() > 255:
                raise ValueError("image values outside [0, 255]")
            rescale = False
        elif img.min() >= 0 and img.max() <= 1:
            rescale = True
        else:
            raise ValueError("image values outside [0, 1]")
        x = (img.astype(np.float64) * 255).astype(np.float32) if rescale else img
        out = np.array(Image.fromarray(x.astype(np.uint8)).resize(
            (w, h), resample=int(self.cfg.get("resample", 3))))
        return ((out.astype(np.float64) * (1 / 255)).astype(np.float32)
                if rescale else out)

    def _crop(self, img: np.ndarray) -> np.ndarray:
        crop = self.cfg.get("crop_size", {"height": 224, "width": 224})
        ch, cw = int(crop["height"]), int(crop["width"])
        h, w = img.shape[:2]
        top, left = (h - ch) // 2, (w - cw) // 2
        if top >= 0 and left >= 0:
            return img[top:top + ch, left:left + cw]
        nh, nw = max(ch, h), max(cw, w)
        padded = np.zeros((nh, nw) + img.shape[2:], img.dtype)
        tp, lp = math.ceil((nh - h) / 2), math.ceil((nw - w) / 2)
        padded[tp:tp + h, lp:lp + w] = img
        top, left = top + tp, left + lp
        return padded[max(0, top):min(nh, top + ch),
                      max(0, left):min(nw, left + cw)]

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float in [0, 1] → [B, h, w, 3] float32."""
        out = []
        for img in np.asarray(images):
            if self.cfg.get("do_resize", True):
                img = self._resize(img)
            if self.cfg.get("do_center_crop", True):
                img = self._crop(img)
            if not np.issubdtype(img.dtype, np.floating):
                img = img.astype(np.float32)
            if self.cfg.get("do_normalize", True):
                mean = np.array(self.cfg.get("image_mean", IMAGENET_MEAN),
                                img.dtype)
                std = np.array(self.cfg.get("image_std", IMAGENET_STD),
                               img.dtype)
                img = (img - mean) / std
            out.append(img)
        return np.stack(out)


def load_hf_dir(path: str) -> Tuple[DinoV2ViT, HFImageProcessor]:
    """A local HF DINOv2 directory → (the ViT with its weights, the
    processor). The weights come from model.safetensors (read here) or
    pytorch_model.bin. The MLP follows the config: SwiGLU under
    `use_swiglu_ffn`, else `hidden_act` (`ACTIVATIONS`; another name
    raises)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(path, "preprocessor_config.json")) as f:
        proc = json.load(f)
    sd = read_hf_weights(path)
    layers, width = int(cfg["num_hidden_layers"]), int(cfg["hidden_size"])
    hub = hub_from_hf(sd, layers)
    model = DinoV2ViT(
        patch_size=int(cfg["patch_size"]), width=width, layers=layers,
        heads=int(cfg["num_attention_heads"]),
        num_registers=(int(hub["register_tokens"].shape[1])
                       if "register_tokens" in hub else 0),
        pos_grid=int(cfg["image_size"]) // int(cfg["patch_size"]),
        mlp_ratio=cfg.get("mlp_ratio", 4),
        eps=float(cfg.get("layer_norm_eps", LN_EPS)), pos_resize="bicubic",
        act=cfg.get("hidden_act", "gelu"),
        swiglu=bool(cfg.get("use_swiglu_ffn", False)))
    return model.load_hub(hub), HFImageProcessor(proc)


class DinoV2DirExtractor(FeatureExtractor):
    """The DINOv2 provider of a local HF directory (JAX
    `DINOv2FeatureExtractor`): the processor's steps on the host, the ViT on
    `device` without the CLS token, the patch grid resized bilinearly
    (`jax.image.resize`) to [B, H, W, width]."""

    def __init__(self, path: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        model, self.processor = load_hf_dir(path)
        self.model = model.requires_grad_(False).eval().to(self.device)

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = rgb.shape
        pix = torch.from_numpy(self.processor(rgb.detach().float().cpu()
                                              .numpy())).to(self.device)
        feats = self.model(pix)
        side = int(math.isqrt(feats.shape[1]))
        return resize_bilinear(feats.reshape(b, side, side, -1), (h, w))
