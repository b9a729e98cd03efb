"""The DINOv2 checkpoint-directory route of the port
(`create_feature_extractor("dinov2", <directory>)`, `models/dinov2.py`)
against JAX's `DINOv2FeatureExtractor`, which reads the same directory with
`transformers`, on the CPU.

A tiny `transformers` Dinov2 (patch 14, width 32, 2 layers, a 5² position
grid, LayerScale 0.5) with its BitImageProcessor (short side 48, centre crop
42: a 3² patch grid, so the position grid is resized) is saved to a
temporary directory, as model.safetensors and as pytorch_model.bin. On 16²
views in [0, 1] (resized up by PIL, as the processor does): the port's
processed pixels equal the processor's bit for bit, and its features equal
JAX's within 1e-5 of their scale (fp32 through two blocks; measured
≈ 2e-7). Also: the port's safetensors reader against the `safetensors`
package, and its directory writer (`save_hf_dir`) read back by
`transformers`.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from manigaussian_tpu.models.foundation import DINOv2FeatureExtractor  # noqa: E402
from manigaussian_tpu_torch.models import dinov2 as TD  # noqa: E402
from manigaussian_tpu_torch.models.foundation import \
    create_feature_extractor  # noqa: E402

TOL = 1e-5


def _hf_dir(path, safe: bool):
    torch.manual_seed(0)
    cfg = transformers.Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                    num_attention_heads=2, patch_size=14,
                                    image_size=70, layerscale_value=0.5)
    model = transformers.Dinov2Model(cfg).eval()
    with torch.no_grad():   # off the init's zeros
        model.embeddings.position_embeddings.normal_(0, 0.2)
        model.embeddings.cls_token.normal_(0, 0.2)
    model.save_pretrained(path, safe_serialization=safe)
    transformers.BitImageProcessor(
        size={"shortest_edge": 48}, crop_size={"height": 42, "width": 42},
        image_mean=list(TD.IMAGENET_MEAN),
        image_std=list(TD.IMAGENET_STD)).save_pretrained(path)
    return model


@pytest.mark.parametrize("safe", [True, False])
def test_dinov2_directory_matches_jax_extractor(tmp_path, safe):
    path = str(tmp_path / "dinov2")
    _hf_dir(path, safe)
    rgb = np.random.default_rng(0).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    ours = create_feature_extractor("dinov2", path, device="cpu")
    assert isinstance(ours, TD.DinoV2DirExtractor)
    theirs = DINOv2FeatureExtractor(path)
    pix = theirs.processor(images=[r for r in rgb], return_tensors="np",
                           do_rescale=False)["pixel_values"]
    np.testing.assert_array_equal(ours.processor(rgb),
                                  pix.transpose(0, 2, 3, 1))
    f_ours = ours(torch.from_numpy(rgb)).numpy()
    f_theirs = np.asarray(theirs(rgb))
    assert f_ours.shape == f_theirs.shape == (2, 16, 16, 32)
    scale = max(1.0, float(np.abs(f_theirs).max()))
    np.testing.assert_allclose(f_ours, f_theirs, atol=TOL * scale, rtol=0)


def test_safetensors_reader_writer_and_hf_dir_round_trip(tmp_path):
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(1)
    tensors = {"a": torch.randn(3, 4, generator=g),
               "b": torch.randn(5, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "d": torch.zeros(0, 2)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = TD.read_safetensors(str(tmp_path / "x.safetensors"))
    TD.write_safetensors(str(tmp_path / "y.safetensors"), tensors)
    back = load_file(str(tmp_path / "y.safetensors"))
    for k, v in tensors.items():
        assert got[k].dtype == back[k].dtype == v.dtype
        assert torch.equal(got[k], v) and torch.equal(back[k], v)
    # the port's writer: transformers reads the directory, and its model
    # equals the port's ViT on the same pixels
    vit = TD.DinoV2ViT(patch_size=14, width=32, layers=2, heads=2, pos_grid=5,
                       pos_resize="bicubic")
    with torch.no_grad():
        for p in vit.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    TD.save_hf_dir(str(tmp_path / "w"), vit)
    hf = transformers.Dinov2Model.from_pretrained(str(tmp_path / "w")).eval()
    pix = torch.randn(1, 3, 42, 42, generator=g)
    with torch.no_grad():
        ref = hf(pixel_values=pix).last_hidden_state[:, 1:]
        ours = vit(pix.permute(0, 2, 3, 1))
    torch.testing.assert_close(ours, ref, atol=TOL, rtol=TOL)
