"""The port's foundation-feature module (`manigaussian_tpu_torch/models/
foundation.py`, `ops/resize.py`) against the JAX package on the CPU.

The stub's projection equals JAX's PRNGKey(0) draw bit for bit and its
features agree within 1e-6; the per-image PCA agrees with JAX's up to a sign
per channel (≤ 2e-3, the bound of tests/test_foundation.py) on the
well-separated spectra that test uses — the port draws its randomized PCA's
Ω from a torch generator, JAX from PRNGKey(0); `extract_gt_embed` and
`embed_fn` run the same pipeline; `create_feature_extractor` takes JAX's
routes with its warnings; the bilinear resize equals `jax.image.resize` in
both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models import foundation as JF
from manigaussian_tpu_torch.models import foundation as TF
from manigaussian_tpu_torch.ops.resize import resize_bilinear

PCA_TOL = 2e-3


def close_up_to_sign(a, b):
    """max over channels of min(|a − b|, |a + b|) per channel [..., k]."""
    return max(min(np.abs(a[..., k] - b[..., k]).max(),
                   np.abs(a[..., k] + b[..., k]).max())
               for k in range(a.shape[-1]))


def separated(seed, n=400, c=32):
    """Features with a strong spectral decay (tests/test_foundation.py)."""
    rs = np.random.RandomState(seed)
    basis = rs.randn(c, c).astype(np.float32)
    weights = rs.randn(n, c).astype(np.float32) * (2.0 ** -np.arange(c))
    return (weights @ basis).astype(np.float32)


def test_stub_projection_equals_jax_bit_for_bit():
    ours = torch.tensor(TF.STUB_PROJECTION, dtype=torch.float32).numpy()
    theirs = np.asarray(JF.StubFeatureExtractor()._w)
    assert ours.shape == theirs.shape == (12, 32)
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 12, 20, 3)])
def test_stub_features_match_jax(shape):
    rgb = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    theirs = np.asarray(JF.StubFeatureExtractor()(jnp.asarray(rgb)))
    ours = TF.StubFeatureExtractor(device="cpu")(torch.from_numpy(rgb)).numpy()
    assert ours.shape == shape[:3] + (32,)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", ["lowrank", "exact"])
def test_pca_to_channels_matches_jax_up_to_sign(method):
    a = separated(0, n=100, c=16)
    theirs = np.asarray(JF.pca_to_channels(jnp.asarray(a), 3, method=method))
    ours = TF.pca_to_channels(torch.from_numpy(a), 3, method=method).numpy()
    assert ours.shape == (100, 3)
    assert close_up_to_sign(ours, theirs) < PCA_TOL


def test_pca_batch_is_one_pca_per_image():
    a = np.stack([separated(1), separated(2)])
    theirs = np.asarray(JF.pca_to_channels_batch(jnp.asarray(a), 3))
    ours = TF.pca_to_channels_batch(torch.from_numpy(a), 3).numpy()
    for i in range(2):
        assert close_up_to_sign(ours[i], theirs[i]) < PCA_TOL
        single = TF.pca_to_channels(torch.from_numpy(a[i]), 3).numpy()
        np.testing.assert_allclose(ours[i], single, atol=1e-5)
    # the port's lowrank and exact paths span the same top-3 projection
    ex = TF.pca_to_channels(torch.from_numpy(a[0]), 3, method="exact").numpy()
    assert close_up_to_sign(ours[0], ex) < PCA_TOL


def jax_omega(c, q):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (c, q), jnp.float32)))


def test_pca_with_jaxs_omega_matches_on_a_flat_spectrum(monkeypatch):
    """On a flat spectrum two QR iterations do not converge, so the
    projection depends on Ω; with JAX's Ω the port computes JAX's."""
    a = np.random.default_rng(3).standard_normal((256, 48)).astype(np.float32)
    theirs = np.asarray(JF.pca_to_channels(jnp.asarray(a), 3))
    monkeypatch.setattr(TF, "pca_omega", jax_omega)
    ours = TF.pca_to_channels(torch.from_numpy(a), 3).numpy()
    assert close_up_to_sign(ours, theirs) < 1e-4 * np.abs(theirs).max()


def test_extract_gt_embed_and_embed_fn_match_jax(monkeypatch):
    rgb = np.random.default_rng(4).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    theirs = np.asarray(JF.extract_gt_embed(jnp.asarray(rgb),
                                            JF.StubFeatureExtractor(), 3))
    monkeypatch.setattr(TF, "pca_omega", jax_omega)
    ex = TF.StubFeatureExtractor(device="cpu")
    ours = TF.extract_gt_embed(torch.from_numpy(rgb), ex, 3).numpy()
    got = ex.embed_fn(3)(rgb)
    assert got.dtype == np.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(got, ours)
    scale = np.abs(theirs).max()
    for i in range(2):
        assert close_up_to_sign(ours[i], theirs[i]) < 1e-4 * scale, i


@pytest.mark.parametrize("src,dst", [((128, 128), (32, 32)),
                                     ((32, 32), (128, 128)),
                                     ((32, 32), (512, 512)),
                                     ((37, 37), (10, 10)),
                                     ((10, 12), (7, 20))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(5).standard_normal((2, *src, 5)).astype(
        np.float32)
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5),
                                         "bilinear"))
    ours = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)


def test_create_feature_extractor_routes(tmp_path, monkeypatch):
    assert TF.create_feature_extractor(None, device="cpu") is None
    assert isinstance(TF.create_feature_extractor("other", device="cpu"),
                      TF.StubFeatureExtractor)
    for name in ("dinov2", "diffusion"):
        with pytest.warns(UserWarning, match=name):
            ex = TF.create_feature_extractor(name, device="cpu")
        assert isinstance(ex, TF.StubFeatureExtractor)
        with pytest.warns(UserWarning, match=name):
            jex = JF.create_feature_extractor(name)
        assert isinstance(jex, JF.StubFeatureExtractor)
    # a missing diffusion checkpoint falls back to the stub, as in JAX
    with pytest.warns(UserWarning, match="diffusion"):
        ex = TF.create_feature_extractor("diffusion", str(tmp_path / "no.ckpt"),
                                         device="cpu")
    assert isinstance(ex, TF.StubFeatureExtractor)
    # a directory is the DINOv2 directory route: one without config.json
    # raises (tests/test_torch_parallel_dinov2_dir.py loads real ones)
    with pytest.raises(FileNotFoundError):
        TF.create_feature_extractor("dinov2", str(tmp_path), device="cpu")
    # a converted .msgpack goes to the port's reader of flax's format (an
    # empty file is truncated; tests/test_torch_convert_weights.py loads
    # real ones)
    msgpack = tmp_path / "sd_vae.msgpack"
    msgpack.write_bytes(b"")
    with pytest.raises(ValueError, match="truncated msgpack"):
        TF.create_feature_extractor("diffusion", str(msgpack), device="cpu")
    # random-init builds the SD VAE at SD v1 width, from seed 0
    monkeypatch.setattr(TF, "FEATURE_HW", 64)
    ex = TF.create_feature_extractor("diffusion", "random-init", device="cpu")
    assert isinstance(ex, TF.SDVaeFeatureExtractor)
    assert ex.feature_hw == 64 and ex.device.type == "cpu"
    assert ex.model.encoder.conv_in.weight.shape == (128, 3, 3, 3)
    assert not any(p.requires_grad for p in ex.model.parameters())
    again = TF.SDVaeFeatureExtractor(None, device="cpu")
    for (k, v), w in zip(ex.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_the_extractor_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, ckpt in (("other", None), ("diffusion", "random-init")):
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.create_feature_extractor(name, ckpt)
    assert TF.create_feature_extractor("other", device="cpu").device.type == "cpu"
