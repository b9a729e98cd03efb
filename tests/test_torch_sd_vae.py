"""The port's SD VAE (`manigaussian_tpu_torch/models/sd_vae.py`) and its
feature extractor against the JAX package on the CPU.

The ch 32 config of tests/test_sd_vae.py (SD v1's topology): the port's
module against the flax `SDVae` on random flax weights carried over by
`convert.sd_vae_state_dict`, and against that file's torch twin of CompVis
AutoencoderKL, whose state dict (CompVis names) loads directly. The latent
and both encoder and decoder taps agree within 1e-4 of each tensor's scale.
Then the extractor from a CompVis checkpoint file against JAX's: the
features within 1e-4, and `embed_fn` against `make_embed_fn` at
feature_hw 64 up to a sign per image and channel, with JAX's PCA Ω (the
features' spectrum is flat, so the randomized PCA depends on Ω; see
tests/test_torch_foundation.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models import foundation as JF
from manigaussian_tpu.models import sd_vae as JV
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.models import foundation as TF
from manigaussian_tpu_torch.models import sd_vae as TV
from tests.test_sd_vae import CH, CH_MULT, NRES, Z, _TorchVaeTwin
from tests.test_torch_foundation import close_up_to_sign, jax_omega
from tests.torch_port_helpers import random_flax_params

TOL = 1e-4
DIMS = dict(ch=CH, ch_mult=CH_MULT, num_res_blocks=NRES, z_channels=Z)


def rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def nhwc_to_nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(0)
    return _TorchVaeTwin().eval()


@pytest.fixture(scope="module")
def flax_case():
    model = JV.SDVae(**DIMS)
    variables = random_flax_params(model, jnp.zeros((1, 32, 32, 3)), seed=1)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return variables, x, model.apply(variables, jnp.asarray(x))


def test_convert_maps_every_flax_leaf_onto_the_port(flax_case):
    variables, _, _ = flax_case
    sd = convert.sd_vae_state_dict(variables)
    own = TV.SDVae(**DIMS).state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    assert len(jax.tree_util.tree_leaves(variables)) == len(own)


@pytest.mark.parametrize("part", ["latent", "encoder_features",
                                  "decoder_features"])
def test_port_vae_matches_flax(flax_case, part):
    variables, x, out = flax_case
    model = TV.SDVae(**DIMS)
    model.load_state_dict(convert.sd_vae_state_dict(variables))
    with torch.no_grad():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    theirs = out[part] if part != "latent" else [out[part]]
    got = ours[part] if part != "latent" else [ours[part]]
    assert len(got) == len(theirs) == (1 if part == "latent" else 2)
    for g, t in zip(got, theirs):
        assert g.shape == nhwc_to_nchw(t).shape
        assert rel_err(g, nhwc_to_nchw(t)) <= TOL, part
    if part == "decoder_features":      # the ManiGaussian feature: stride 4
        assert got[-1].shape == (2, CH * CH_MULT[2], 8, 8)


def test_compvis_state_dict_loads_directly(twin):
    sd = {f"first_stage_model.{k}": v for k, v in twin.state_dict_compat().items()}
    assert TV.dims_from_state_dict(sd) == DIMS
    model = TV.SDVae(**TV.dims_from_state_dict(sd)).load_compvis(sd)
    # the decoder stops after its last tap: the two high-resolution levels
    # and the output head are not built
    assert not any(k.startswith(("decoder.up.1.", "decoder.up.0.",
                                 "decoder.norm_out", "decoder.conv_out"))
                   for k in model.state_dict())
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    latent, enc, dec = twin(x)
    with torch.no_grad():
        out = model(x)
    assert rel_err(out["latent"], latent) <= TOL
    for got, ref in zip(out["encoder_features"] + out["decoder_features"],
                        enc + dec):
        assert rel_err(got, ref) <= TOL
    with pytest.raises(KeyError):
        TV.SDVae(**DIMS).load_compvis(
            {k: v for k, v in sd.items() if "quant_conv" not in k})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, twin):
    path = tmp_path_factory.mktemp("vae") / "sd.ckpt"
    torch.save({"state_dict": {f"first_stage_model.{k}": v for k, v
                               in twin.state_dict_compat().items()}}, str(path))
    return str(path)


def test_extractor_from_a_compvis_checkpoint_matches_jax(checkpoint):
    rgb = np.random.default_rng(3).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    theirs = np.asarray(JF.SDVaeFeatureExtractor(checkpoint, feature_hw=32)(
        jnp.asarray(rgb)))
    ex = TF.create_feature_extractor("diffusion", checkpoint, device="cpu")
    assert isinstance(ex, TF.SDVaeFeatureExtractor)
    ex.feature_hw = 32
    ours = ex(torch.from_numpy(rgb)).numpy()
    assert ours.shape == (2, 16, 16, CH * CH_MULT[2])
    assert rel_err(ours, theirs) <= TOL


def test_embed_fn_matches_jax_make_embed_fn(checkpoint, monkeypatch):
    rgb = np.random.default_rng(4).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    jex = JF.SDVaeFeatureExtractor(checkpoint, feature_hw=64)
    theirs = np.asarray(jex.make_embed_fn(3)(jnp.asarray(rgb)))
    monkeypatch.setattr(TF, "pca_omega", jax_omega)
    ours = TF.SDVaeFeatureExtractor(checkpoint, feature_hw=64,
                                    device="cpu").embed_fn(3)(rgb)
    assert ours.shape == theirs.shape == (2, 32, 32, 3)
    assert ours.dtype == np.float32
    for i in range(2):
        assert close_up_to_sign(ours[i], theirs[i]) \
            <= TOL * np.abs(theirs[i]).max(), i
