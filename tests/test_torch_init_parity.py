"""The port's initializers against flax's, in distribution, on the CPU.

Each package initializes its own network from three seeds (flax
`init_state` from PRNGKey(seed), the port's `initialize` from a torch
generator of that seed) at the micro widths of `w_geo`, `w_geo_sem_dyna`
and GNFACTOR_BC; the values of each leaf are pooled over the seeds.
The parity tests elsewhere start both packages from the same numpy-drawn
weights, so only this test sees the initializers themselves.

Per leaf: a leaf that flax fills with one constant (zeros, ones) is that
constant in the port too; otherwise the port's standard deviation is
within 5/√(2N) + 1 % of flax's (the sampling error of a standard deviation
over N values is about 1/√(2N) of it) and its mean within 5 σ/√N + 1e-6;
and where N ≥ 2000, the kurtosis (1.8 for a uniform draw, 2.37 for
flax's normal truncated at ±2 σ, 3 for a normal) within 6·√(24/N) + 0.05,
which tells the draw's family apart at that size.

The U-Net's 1×1 out conv is a plain flax `nn.Conv` (lecun_normal, std
1/√fan_in), not a block whose activation picks the initializer; the micro
widths (8 → 16) hide little of a wrong draw there, so a second test builds
the port's U-Net at `w_geo`'s widths (8 → 128), where xavier_uniform would
give 0.121 against flax's 0.354.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manigaussian_tpu.agents.registry import create_agent as j_create_agent
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.registry import create_agent
from tests.torch_port_helpers import torch_config

SEEDS = (0, 1, 2)


def _case(name):
    if name == "w_geo":
        from tests.test_torch_train import make_batch, micro_cfg
        return micro_cfg(), make_batch()
    if name == "w_geo_sem_dyna":
        from tests.test_torch_train_sem import make_sem_batch, micro_sem_cfg
        return micro_sem_cfg(), make_sem_batch()
    from tests.test_torch_train_gnfactor import gnf_batch, gnf_cfg
    return gnf_cfg(), gnf_batch(True)


def _kurtosis(x):
    d = x - x.mean()
    return float((d ** 4).mean() / (d ** 2).mean() ** 2)


def _unlike_flax(jax_sd, port_sd):
    """The leaves whose port values, pooled over SEEDS, break the rules
    above; jax_sd(seed) / port_sd(seed) give each package's own init as a
    state dict of the port's names."""
    pooled = {"jax": {}, "port": {}}
    for seed in SEEDS:
        sds = {"jax": jax_sd(seed), "port": port_sd(seed)}
        assert set(sds["jax"]) == set(sds["port"])
        for pkg, sd in sds.items():
            for k, v in sd.items():
                pooled[pkg].setdefault(k, []).append(
                    v.detach().numpy().astype(np.float64).ravel())
    bad = []
    for k in sorted(pooled["jax"]):
        x = np.concatenate(pooled["jax"][k])
        y = np.concatenate(pooled["port"][k])
        n = x.size
        if x.std() == 0:
            if not (y == x[0]).all():
                bad.append((k, "constant", x[0], y.min(), y.max()))
            continue
        ratio = y.std() / x.std() - 1
        if abs(ratio) > 5 / np.sqrt(2 * n) + 0.01:
            bad.append((k, "std", n, x.std(), y.std()))
        if abs(y.mean() - x.mean()) > 5 * x.std() / np.sqrt(n) + 1e-6:
            bad.append((k, "mean", n, x.mean(), y.mean()))
        if n >= 2000 and abs(_kurtosis(y) - _kurtosis(x)) > \
                6 * np.sqrt(24 / n) + 0.05:
            bad.append((k, "kurtosis", n, _kurtosis(x), _kurtosis(y)))
    return bad


@pytest.mark.parametrize("name", ["w_geo", "w_geo_sem_dyna", "GNFACTOR_BC"])
def test_initializers_equal_flax_in_distribution(name):
    cfg, batch = _case(name)
    jagent = j_create_agent(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key: jagent.init_state(key, jb).params)
    bad = _unlike_flax(
        lambda seed: convert.qfunction_state_dict(
            jax.device_get(init(jax.random.PRNGKey(seed)))),
        lambda seed: create_agent(torch_config(cfg), device="cpu",
                                  seed=seed).qfn.state_dict())
    assert not bad, bad


def _library_case(name):
    """(flax module, its init inputs, the state-dict converter, the port's
    module initialized from a seed) of a module no policy builds: the
    attention3d library at 64 voxel and 96 language channels, 4 heads of
    16; the `random-init` SD VAE tower at tests/test_torch_sd_vae's width."""
    import torch

    from manigaussian_tpu_torch.models.blocks import initialize
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    if name == "attention3d":
        from manigaussian_tpu.models import attention3d as JA
        from manigaussian_tpu_torch.models import attention3d as TA
        c, cl, heads, dim_head = 64, 96, 4, 16
        return (JA.Visual3DLangTransformer(heads=heads, dim_head=dim_head),
                (jnp.zeros((1, 2, 2, 2, c)), jnp.zeros((1, 3, cl))),
                convert.attention3d_state_dict,
                lambda seed: initialize(TA.Visual3DLangTransformer(
                    c, cl, heads, dim_head), gen(seed)))
    from manigaussian_tpu.models import sd_vae as JV
    from manigaussian_tpu_torch.models import sd_vae as TV
    from tests.test_torch_sd_vae import DIMS
    return (JV.SDVae(**DIMS), (jnp.zeros((1, 32, 32, 3)),),
            convert.sd_vae_state_dict,
            lambda seed: TV.SDVae(**DIMS).init_params(gen(seed)))


@pytest.mark.parametrize("name", ["attention3d", "sd_vae"])
def test_library_initializers_equal_flax_in_distribution(name):
    """Flax's `init` against the port's initializers (`blocks.initialize`;
    `SDVae.init_params` for `random-init`): lecun_normal weights truncated
    at ±2σ as flax draws them, zero biases, norms ones and zeros."""
    jm, inputs, to_sd, port = _library_case(name)
    init = jax.jit(lambda key: jm.init(key, *inputs))
    bad = _unlike_flax(
        lambda seed: to_sd(jax.device_get(init(jax.random.PRNGKey(seed)))),
        lambda seed: port(seed).state_dict())
    assert not bad, bad


def test_unet_out_conv_is_lecun_normal_at_w_geo_width():
    """The port's `w_geo` U-Net at its published widths (channels 8, 16,
    32, 64; 128 out): the out conv's weights [128, 8, 1, 1, 1], pooled over
    the seeds, have flax's lecun_normal std 1/√8 within 5/√(2N) + 1 %, and
    lie within the truncation at ±2 of the untruncated normal's σ."""
    import torch

    from manigaussian_tpu_torch.models.blocks import initialize
    from manigaussian_tpu_torch.models.unet3d import VoxelUNetShallow
    ws = [initialize(VoxelUNetShallow(10, 128, (8, 16, 32, 64)),
                     torch.Generator().manual_seed(s)).out.weight
          for s in SEEDS]
    assert tuple(ws[0].shape) == (128, 8, 1, 1, 1)
    y = torch.cat([w.detach().reshape(-1) for w in ws]).double().numpy()
    n, std = y.size, 1 / np.sqrt(8)
    assert abs(y.std() / std - 1) <= 5 / np.sqrt(2 * n) + 0.01, y.std()
    assert np.abs(y).max() <= 2 * std / 0.87962566103423978
    assert abs(_kurtosis(y) - 2.37) <= 6 * np.sqrt(24 / n) + 0.05
