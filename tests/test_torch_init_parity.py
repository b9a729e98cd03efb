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

One leaf differs, and the test pins it (`KNOWN`): the U-Net's 1×1 out conv
is a flax `nn.Conv` in the JAX package (lecun_normal, std 1/√fan_in) and a
`Conv3DBlock` without activation in the port (xavier_uniform, std
√(2/(fan_in + fan_out))): 0.289 against 0.354 at these widths (8 → 16),
0.121 against 0.354 at `w_geo`'s (8 → 128). ROADMAP.md queues the fix.
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
# leaf → the port's initializer where it is not flax's
KNOWN = {"qnet.encoder_3d.out.weight": "xavier_uniform"}


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


@pytest.mark.parametrize("name", ["w_geo", "w_geo_sem_dyna", "GNFACTOR_BC"])
def test_initializers_equal_flax_in_distribution(name):
    cfg, batch = _case(name)
    jagent = j_create_agent(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key: jagent.init_state(key, jb).params)
    pooled = {"jax": {}, "port": {}}
    shapes = {}
    for seed in SEEDS:
        sd = convert.qfunction_state_dict(
            jax.device_get(init(jax.random.PRNGKey(seed))))
        tsd = create_agent(torch_config(cfg), device="cpu",
                           seed=seed).qfn.state_dict()
        assert set(tsd) == set(sd)
        shapes = {k: tuple(v.shape) for k, v in tsd.items()}
        for pkg, d in (("jax", sd), ("port", tsd)):
            for k, v in d.items():
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
        if k in KNOWN:      # a 1×1×1 conv: [out, in, 1, 1, 1]
            fan_out, fan_in = shapes[k][:2]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(y).max() <= limit
            np.testing.assert_allclose(y.std(), limit / np.sqrt(3.0),
                                       rtol=5 / np.sqrt(2 * n) + 0.01)
        if abs(y.mean() - x.mean()) > 5 * x.std() / np.sqrt(n) + 1e-6:
            bad.append((k, "mean", n, x.mean(), y.mean()))
        if n >= 2000 and abs(_kurtosis(y) - _kurtosis(x)) > \
                6 * np.sqrt(24 / n) + 0.05:
            bad.append((k, "kurtosis", n, _kurtosis(x), _kurtosis(y)))
    assert sorted({b[0] for b in bad}) == sorted(KNOWN), bad
