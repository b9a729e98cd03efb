"""JAX parameter tree → this package's `state_dict`.

Input: the nested dict of numpy arrays that `jax.device_get` returns for the
JAX agent's parameters (`TrainState.params`, i.e. {"params": {"qnet": ...}}),
or its "qnet" subtree. Output: the `QFunction` state_dict (keys "qnet.…").

Layouts: Dense kernel [in, out] → weight [out, in]; conv kernel DHWIO →
OIDHW; LayerNorm/GroupNorm `scale` → `weight`. Conv3DBlock keeps its kernel
either directly ({kernel, bias}: the 'z2d'/'pallas' fast path) or under
`Conv_0` (the 'xla' path and every edge-padded conv); both are read. The
U-Net's parameter names follow construction order in flax (a nested
`A(B(x))` names A first), and the 'packed' impl names them as the inverse of
`packed3d.transplant_unet_params`; both impls map onto the plain U-Net.

The `neural_renderer` subtree of the Gaussian renderer maps onto the
renderer's modules (`gs_model/encoder`, `gs_model/regresser`,
`gs_model/deformation`, whose first layer is 3 inputs wider in the semantic
tiers), so a whole JAX `TrainState.params` tree loads; the GNFactor NeRF
renderer's tree (`neural_renderer/nerf/mlp/...`, a ResnetFC) maps onto
`rendering/nerf_renderer.GNFactorNeRFRenderer`'s `nerf.mlp`.

The frozen towers of the semantic tiers: `sd_vae_state_dict` (the flax
`SDVae` variables → `models/sd_vae.SDVae`, CompVis names) and
`dinov2_state_dict` (the flax `DinoV2ViT` variables →
`models/dinov2.DinoV2ViT`, torch-hub names); conv kernels HWIO → OIHW.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# U-Net module (port) ← flax names, 'packed' impl
_UNET_PACKED = {
    "enc0": "PackedConvNormAct3D_0", "enc1": "PackedConvNormAct3D_1",
    "enc1_down": "PackedConvNormAct3D_2", "enc2": "ConvNormAct3D_0",
    "enc2_down": "ConvNormAct3D_1", "mid": "ConvNormAct3D_2",
    "mid_down": "ConvNormAct3D_3", "up2": ("Conv_0", "GroupNorm_0"),
    "up1": "PackedConvNormAct3D_3", "up0": "PackedConvNormAct3D_4",
    "out": "Conv_1",
}
# ... and 'xla' impl (also what 'packed' falls back to when V % 4 != 0)
_UNET_PLAIN = {
    "enc0": "ConvNormAct3D_0", "enc1": "ConvNormAct3D_1",
    "enc1_down": "ConvNormAct3D_2", "enc2": "ConvNormAct3D_3",
    "enc2_down": "ConvNormAct3D_4", "mid": "ConvNormAct3D_5",
    "mid_down": "ConvNormAct3D_6", "up2": ("Conv_0", "GroupNorm_0"),
    "up1": ("Conv_1", "GroupNorm_1"), "up0": ("Conv_2", "GroupNorm_2"),
    "out": "Conv_3",
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:
    """DHWIO → OIDHW."""
    return _t(kernel).permute(4, 3, 0, 1, 2).contiguous()


def _dense(tree: Mapping, prefix: str, out: Dict) -> None:
    out[prefix + "weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        out[prefix + "bias"] = _t(tree["bias"])


def _norm(tree: Mapping, prefix: str, out: Dict) -> None:
    out[prefix + "weight"] = _t(tree["scale"])
    out[prefix + "bias"] = _t(tree["bias"])


def _conv_block(tree: Mapping, prefix: str, out: Dict) -> None:
    tree = tree if "kernel" in tree else tree["Conv_0"]
    out[prefix + "weight"] = _conv(tree["kernel"])
    out[prefix + "bias"] = _t(tree["bias"])


def _conv_norm(tree: Mapping, prefix: str, out: Dict,
               conv: str = "Conv_0", norm: str = "GroupNorm_0") -> None:
    """ConvNormAct3D: the packed form keeps {kernel, scale, bias} flat."""
    if "kernel" in tree:
        out[prefix + "weight"] = _conv(tree["kernel"])
        out[prefix + "norm.weight"] = _t(tree["scale"])
        out[prefix + "norm.bias"] = _t(tree["bias"])
    else:
        out[prefix + "weight"] = _conv(tree[conv]["kernel"])
        _norm(tree[norm], prefix + "norm.", out)


def _unet(tree: Mapping, prefix: str, out: Dict) -> None:
    names = _UNET_PACKED if "PackedConvNormAct3D_0" in tree else _UNET_PLAIN
    for mod, src in names.items():
        p = f"{prefix}{mod}."
        if mod == "out":
            _conv_block(tree[src], p, out)
        elif isinstance(src, tuple):
            out[p + "weight"] = _conv(tree[src[0]]["kernel"])
            _norm(tree[src[1]], p + "norm.", out)
        else:
            _conv_norm(tree[src], p, out)


def _prenorm_attention(tree: Mapping, prefix: str, out: Dict) -> None:
    _norm(tree["LayerNorm_0"], prefix + "norm.", out)
    if "LayerNorm_1" in tree:
        _norm(tree["LayerNorm_1"], prefix + "norm_context.", out)
    att = tree["Attention_0"]
    for name in ("to_q", "to_kv", "to_out"):
        _dense(att[name], f"{prefix}attn.{name}.", out)


def _prenorm_ff(tree: Mapping, prefix: str, out: Dict) -> None:
    _norm(tree["LayerNorm_0"], prefix + "norm.", out)
    ff = tree["GEGLUFeedForward_0"]
    _dense(ff["Dense_0"], prefix + "ff.proj.", out)
    _dense(ff["Dense_1"], prefix + "ff.out.", out)


def perceiver_state_dict(q: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX `PerceiverVoxelLangEncoder` tree → PerceiverVoxelLangEncoder
    state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _unet(q["encoder_3d"], prefix + "encoder_3d.", out)
    p = prefix + "patchify."
    out[p + "weight"] = _conv(q["patchify"]["kernel"])
    out[p + "bias"] = _t(q["patchify"]["bias"])
    if "proprio_preprocess" in q:
        _dense(q["proprio_preprocess"]["Dense_0"],
               prefix + "proprio_preprocess.dense.", out)
    _dense(q["lang_preprocess"], prefix + "lang_preprocess.", out)
    out[prefix + "pos_encoding"] = _t(q["pos_encoding"])
    out[prefix + "latents"] = _t(q["latents"])
    _prenorm_attention(q["cross_attn"], prefix + "cross_attn.", out)
    _prenorm_ff(q["cross_ff"], prefix + "cross_ff.", out)
    i = 0
    while f"self_attn_{i}" in q:
        _prenorm_attention(q[f"self_attn_{i}"], f"{prefix}self_attn.{i}.", out)
        _prenorm_ff(q[f"self_ff_{i}"], f"{prefix}self_ff.{i}.", out)
        i += 1
    _prenorm_attention(q["decoder_cross_attn"], prefix + "decoder_cross_attn.",
                       out)
    _conv_block(q["up0"]["Conv3DBlock_0"], prefix + "up0.conv_a.", out)
    _conv_block(q["up0"]["Conv3DBlock_1"], prefix + "up0.conv_b.", out)
    _conv_block(q["final"], prefix + "final.", out)
    p = prefix + "trans_decoder."
    out[p + "weight"] = _conv(q["trans_decoder"]["kernel"])
    out[p + "bias"] = _t(q["trans_decoder"]["bias"])
    for name in ("dense0", "dense1", "rot_grip_collision_ff"):
        if name in q:
            _dense(q[name]["Dense_0"], f"{prefix}{name}.dense.", out)
    return out


def unet_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX `VoxelUNetShallow` tree ('packed' or 'xla') → VoxelUNetShallow
    state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _unet(tree, "", out)
    return out


def _resnetfc(tree: Mapping, prefix: str, out: Dict) -> None:
    """flax ResnetFC (Dense_0, lin_z_i, block_i/{Dense_0, Dense_1}, Dense_1)
    → models/gaussian_regressor.ResnetFC."""
    _dense(tree["Dense_0"], prefix + "lin_in.", out)
    i = 0
    while f"lin_z_{i}" in tree:
        _dense(tree[f"lin_z_{i}"], f"{prefix}lin_z.{i}.", out)
        i += 1
    i = 0
    while f"block_{i}" in tree:
        _dense(tree[f"block_{i}"]["Dense_0"], f"{prefix}blocks.{i}.fc0.", out)
        _dense(tree[f"block_{i}"]["Dense_1"], f"{prefix}blocks.{i}.fc1.", out)
        i += 1
    _dense(tree["Dense_1"], prefix + "lin_out.", out)


def renderer_state_dict(tree: Mapping,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX `NeuralRenderer` tree → NeuralRenderer state_dict, or the
    `GNFactorNeRFRenderer` tree → GNFactorNeRFRenderer state_dict."""
    out: Dict[str, torch.Tensor] = {}
    if "nerf" in tree:
        _resnetfc(tree["nerf"]["mlp"], prefix + "nerf.mlp.", out)
        return out
    gs = tree["gs_model"]
    _resnetfc(gs["encoder"], prefix + "gs_model.encoder.", out)
    _dense(gs["regresser"]["Dense_0"], prefix + "gs_model.regresser.", out)
    if "deformation" in gs:
        _resnetfc(gs["deformation"], prefix + "gs_model.deformation.", out)
    return out


def qfunction_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX agent parameters → `QFunction` state_dict. Accepts the full tree
    ({"params": {"qnet": ..., "neural_renderer": ...}}) or its "qnet"
    subtree."""
    tree = params.get("params", params)
    out = perceiver_state_dict(tree.get("qnet", tree), prefix="qnet.")
    if "neural_renderer" in tree:
        out.update(renderer_state_dict(tree["neural_renderer"],
                                       prefix="neural_renderer."))
    return out


# flax SDVae module names → CompVis (the port's) names
_VAE_NAMES = ((r"down_(\d+)_block_(\d+)", r"down.\1.block.\2"),
              (r"down_(\d+)_downsample", r"down.\1.downsample.conv"),
              (r"up_(\d+)_block_(\d+)", r"up.\1.block.\2"),
              (r"up_(\d+)_upsample", r"up.\1.upsample.conv"),
              (r"mid_(block_\d|attn_\d)", r"mid.\1"))


def _flat(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def sd_vae_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The flax `SDVae` variables ({"params": ...} or the params) →
    models/sd_vae.SDVae state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flat(variables.get("params", variables)):
        names = []
        for name in path[:-1]:
            for pat, rep in _VAE_NAMES:
                name = re.sub(f"^{pat}$", rep, name)
            names.append(name)
        prefix = ".".join(names)
        x = _t(leaf)
        if path[-1] == "kernel":           # HWIO → OIHW
            out[prefix + ".weight"] = x.permute(3, 2, 0, 1).contiguous()
        else:
            out[prefix + (".weight" if path[-1] == "scale" else ".bias")] = x
    return out


def dinov2_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The flax `DinoV2ViT` variables → models/dinov2.DinoV2ViT state_dict
    (torch-hub names)."""
    p = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {
        "cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"]),
        "patch_embed.proj.weight":
            _t(p["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    if "register_tokens" in p:
        out["register_tokens"] = _t(p["register_tokens"])
    _norm(p["norm"], "norm.", out)
    i = 0
    while f"block_{i}" in p:
        blk, pre = p[f"block_{i}"], f"blocks.{i}."
        _norm(blk["norm1"], pre + "norm1.", out)
        _norm(blk["norm2"], pre + "norm2.", out)
        for name, dst in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                          ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _dense(blk[name], f"{pre}{dst}.", out)
        out[pre + "ls1.gamma"] = _t(blk["ls1_gamma"])
        out[pre + "ls2.gamma"] = _t(blk["ls2_gamma"])
        i += 1
    return out
