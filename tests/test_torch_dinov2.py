"""The port's DINOv2 tower (`manigaussian_tpu_torch/models/dinov2.py`)
against the JAX package and tests/test_dinov2.py's torch twin on the CPU.

The twin's torch-hub state dict loads into the port directly and its
`x_norm_patchtokens` agree; the port against the flax `DinoV2ViT` on random
flax weights carried over by `convert.dinov2_state_dict`, with and without
register tokens; the extractor from a checkpoint file against JAX's
`DinoV2JaxExtractor`, with the position grid enlarged and shrunk. All
within 1e-4 of each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models import dinov2 as JD
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.models import dinov2 as TD
from manigaussian_tpu_torch.models import foundation as TF
from tests.test_dinov2 import GRID, HEADS, LAYERS, PATCH, WIDTH, _TorchDinoTwin
from tests.torch_port_helpers import random_flax_params

TOL = 1e-4


def rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def test_hub_state_dict_loads_directly_and_matches_the_twin():
    torch.manual_seed(0)
    twin = _TorchDinoTwin().eval()
    sd = twin.clip_state_dict()
    dims = TD.dims_from_state_dict(sd)
    assert dims == JD.dims_from_state_dict(sd)
    model = TD.DinoV2ViT(**{**dims, "heads": HEADS}).load_hub(
        {**sd, "mask_token": torch.zeros(1, WIDTH)})
    img = np.random.default_rng(0).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = twin.forward_features(torch.from_numpy(img).permute(0, 3, 1, 2))
        got = model(torch.from_numpy(img))
    assert got.shape == (2, GRID * GRID, WIDTH)
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("registers", [0, 2])
def test_port_matches_flax_through_convert(registers):
    jm = JD.DinoV2ViT(patch_size=PATCH, width=WIDTH, layers=LAYERS,
                      heads=HEADS, num_registers=registers, pos_grid=GRID)
    img = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    variables = random_flax_params(jm, jnp.asarray(img), seed=2)
    sd = convert.dinov2_state_dict(variables)
    model = TD.DinoV2ViT(patch_size=PATCH, width=WIDTH, layers=LAYERS,
                         heads=HEADS, num_registers=registers, pos_grid=GRID)
    assert set(sd) == set(model.state_dict())
    assert len(jax.tree_util.tree_leaves(variables)) == len(sd)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    ref = np.asarray(jm.apply(variables, jnp.asarray(img)))
    assert got.shape == ref.shape == (2, GRID * GRID, WIDTH)
    assert rel_err(got, ref) <= TOL


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    torch.manual_seed(1)
    path = tmp_path_factory.mktemp("dino") / "tiny_dino.pt"
    torch.save(_TorchDinoTwin().clip_state_dict(), str(path))
    return str(path)


@pytest.mark.parametrize("hw", [16, 5])     # patch grid 8 (> GRID) and 3 (<)
def test_extractor_matches_jax(checkpoint, hw):
    rgb = np.random.default_rng(2).uniform(size=(1, hw, hw, 3)).astype(
        np.float32)
    theirs = np.asarray(JD.DinoV2JaxExtractor(checkpoint)(jnp.asarray(rgb)))
    ex = TF.create_feature_extractor("dinov2", checkpoint, device="cpu")
    assert isinstance(ex, TD.DinoV2Extractor)
    ours = ex(torch.from_numpy(rgb)).numpy()
    assert ours.shape == theirs.shape == (1, hw, hw, WIDTH)
    assert rel_err(ours, theirs) <= TOL
    embed = ex.embed_fn(3)(rgb)
    assert embed.shape == (1, hw, hw, 3) and np.isfinite(embed).all()
