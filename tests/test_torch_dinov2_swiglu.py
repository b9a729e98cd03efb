"""The port's DINOv2 directory route with the MLPs of other DINOv2 configs
(`models/dinov2.py`: the SwiGLU MLP of the giant model, `hidden_act`
through `ACTIVATIONS`) against JAX's `DINOv2FeatureExtractor`, which reads
the same directory with `transformers`, on the CPU.

Tiny `transformers` Dinov2 directories (patch 14, width 32, 2 layers, a 5²
position grid, LayerScale 0.5; BitImageProcessor short side 48, crop 42) as
in tests/test_torch_parallel_dinov2_dir.py: features within 1e-5 of their
scale (fp32 through two blocks). Under `use_swiglu_ffn` the config's
`hidden_act` is ignored, as `transformers` ignores it. Also: the port's
writer (`save_hf_dir`) of a SwiGLU ViT read back by `transformers`, and an
unknown activation named in the error.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from manigaussian_tpu.models.foundation import DINOv2FeatureExtractor  # noqa: E402
from manigaussian_tpu_torch.models import dinov2 as TD  # noqa: E402
from manigaussian_tpu_torch.models.foundation import \
    create_feature_extractor  # noqa: E402

TOL = 1e-5


def _hf_dir(path, **cfg_kw):
    torch.manual_seed(0)
    cfg = transformers.Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                    num_attention_heads=2, patch_size=14,
                                    image_size=70, layerscale_value=0.5,
                                    **cfg_kw)
    model = transformers.Dinov2Model(cfg).eval()
    with torch.no_grad():   # off the init's zeros and the small biases
        model.embeddings.position_embeddings.normal_(0, 0.2)
        model.embeddings.cls_token.normal_(0, 0.2)
        for name, p in model.named_parameters():
            if "mlp" in name:
                p.normal_(0, 0.3)
    model.save_pretrained(path)
    transformers.BitImageProcessor(
        size={"shortest_edge": 48}, crop_size={"height": 42, "width": 42},
        image_mean=list(TD.IMAGENET_MEAN),
        image_std=list(TD.IMAGENET_STD)).save_pretrained(path)
    return model


@pytest.mark.parametrize("cfg_kw", [
    {"use_swiglu_ffn": True},
    {"use_swiglu_ffn": True, "hidden_act": "relu"},   # ignored under SwiGLU
    {"hidden_act": "gelu_new"},
    {"hidden_act": "quick_gelu", "mlp_ratio": 2},
], ids=["swiglu", "swiglu_relu_ignored", "gelu_new", "quick_gelu_ratio2"])
def test_dinov2_directory_mlps_match_jax_extractor(tmp_path, cfg_kw):
    path = str(tmp_path / "dinov2")
    _hf_dir(path, **cfg_kw)
    rgb = np.random.default_rng(0).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    ours = create_feature_extractor("dinov2", path, device="cpu")
    assert ours.model.swiglu == bool(cfg_kw.get("use_swiglu_ffn"))
    f_ours = ours(torch.from_numpy(rgb)).numpy()
    f_theirs = np.asarray(DINOv2FeatureExtractor(path)(rgb))
    assert f_ours.shape == f_theirs.shape == (2, 16, 16, 32)
    scale = max(1.0, float(np.abs(f_theirs).max()))
    np.testing.assert_allclose(f_ours, f_theirs, atol=TOL * scale, rtol=0)


def test_swiglu_writer_read_back_by_transformers(tmp_path):
    g = torch.Generator().manual_seed(1)
    vit = TD.DinoV2ViT(patch_size=14, width=32, layers=2, heads=2, pos_grid=5,
                       pos_resize="bicubic", swiglu=True)
    assert vit.blocks[0].mlp.w12.out_features == 2 * TD.swiglu_hidden(32, 4)
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    TD.save_hf_dir(str(tmp_path / "w"), vit)
    with open(tmp_path / "w" / "config.json") as f:
        assert json.load(f)["use_swiglu_ffn"] is True
    hf = transformers.Dinov2Model.from_pretrained(str(tmp_path / "w")).eval()
    assert type(hf.encoder.layer[0].mlp).__name__ == "Dinov2SwiGLUFFN"
    pix = torch.randn(1, 3, 42, 42, generator=g)
    with torch.no_grad():
        ref = hf(pixel_values=pix).last_hidden_state[:, 1:]
        ours = vit(pix.permute(0, 2, 3, 1))
    torch.testing.assert_close(ours, ref, atol=TOL, rtol=TOL)
    back, _ = TD.load_hf_dir(str(tmp_path / "w"))
    for (k, a), (k2, b) in zip(vit.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_unknown_activation_is_named(tmp_path):
    path = str(tmp_path / "dinov2")
    _hf_dir(path)
    with open(f"{path}/config.json") as f:
        cfg = json.load(f)
    cfg["hidden_act"] = "mish"
    with open(f"{path}/config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="'mish'"):
        TD.load_hf_dir(path)
