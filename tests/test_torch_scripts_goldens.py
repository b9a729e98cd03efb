"""The port's `make_goldens` and its numpy threefry against JAX on the CPU.

`utils/threefry`: keys, `split`, 32-bit draws, `uniform` and `normal` equal
`jax.random`'s bit for bit (under the installed JAX's default
`jax_threefry_partitionable`, which the module follows); its log1p equals
XLA's CPU log1p bit for bit on a grid through both of its branches and the
special values.

`make_goldens`: the scenes' inputs equal the JAX script's `scene_from_depth`
(the random draws bit for bit; the unprojected means to 3e-8, torch's
unprojection against jnp's); the fixtures regenerated through the port's
oracle (`ops/rasterizer_ref.py`) hold against the committed ones
(tests/goldens/, which the JAX script reproduces today:
`test_goldens_equal_the_jax_script_today`, marked slow, runs it) on every
element: the loss to rtol 1e-5 and the radii exact (tests/test_goldens.py:70,
77), the frames to atol 1e-5 / rtol 1e-4, the gradients to rtol 1e-4 with
atol 1e-5 of the array's largest magnitude (sums of thousands of float32
pixel terms). That is ten times the JAX oracle's self-reproduction bound
(tests/test_goldens.py:71-80), which measures XLA's CPU rounding: a float64
render of the same inputs, nearer the exact frames than either float32
render, misses it as well (`test_oracle_bound_is_float32_rounding`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from manigaussian_tpu_torch.scripts import make_goldens as tmg
from manigaussian_tpu_torch.utils import threefry
from tests.test_goldens import FIXTURES, PARAM_KEYS
from tests.torch_port_helpers import jax_script

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 33 + 5])
def test_threefry_draws_equal_jax_bit_for_bit(seed):
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(key))
    ks = jax.random.split(key, 5)
    np.testing.assert_array_equal(threefry.split(threefry.prng_key(seed), 5),
                                  np.asarray(ks))
    for i, shape in enumerate([(1000,), (37, 3), (64, 4, 3)]):
        k = threefry.split(threefry.prng_key(seed), 5)[i]
        np.testing.assert_array_equal(
            threefry.random_bits(k, shape),
            np.asarray(jax.random.bits(ks[i], shape)))
        for lo, hi in ((0.0, 1.0), (0.3, 0.95), (0.5, 2.0), (-3.3, 7.1)):
            np.testing.assert_array_equal(
                _bits(threefry.uniform(k, shape, lo, hi)),
                _bits(jax.random.uniform(ks[i], shape, minval=lo,
                                         maxval=hi)))
        np.testing.assert_array_equal(
            _bits(threefry.normal(k, shape)),
            _bits(jax.random.normal(ks[i], shape)))
    np.testing.assert_array_equal(
        _bits(threefry.normal(threefry.prng_key(seed), (100_000,))),
        _bits(jax.random.normal(key, (100_000,))))


def test_log1p_is_xlas():
    x = np.concatenate([np.linspace(-1, 3, 100_001, dtype=np.float32),
                        np.float32([-1, 0, -0.0, np.inf, -2, 1e-30, -1e-30,
                                    0.41421354, -0.41421354, 1e30])])
    want = np.asarray(jax.jit(jnp.log1p)(x))
    with np.errstate(all="ignore"):
        got = threefry.log1p(x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def test_scene_inputs_equal_the_jax_script():
    jmg = jax_script("make_goldens")
    want = jmg.scene_from_depth(32, 32, key=0)
    got = tmg.scene_from_depth(32, 32, key=0)
    for k in ("scales", "rotations", "opacities", "language_features"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    np.testing.assert_allclose(got["means3d"], want["means3d"], atol=3e-8,
                               rtol=0)
    # shs: a position-derived color plus normal draws
    np.testing.assert_array_equal(_bits(got["shs"][:, 1:]),
                                  _bits(want["shs"][:, 1:]))
    np.testing.assert_allclose(got["shs"], want["shs"], atol=1e-6, rtol=0)
    for i, w in enumerate(tmg.loss_weights(64, 64)):
        np.testing.assert_array_equal(
            _bits(w), _bits(jax.random.normal(
                jax.random.PRNGKey(7 + i), w.shape)))


def _hold(got, want, name):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in ("intrinsic", "c2w", "znear", "zfar", "width", "height",
              "golden_radii"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("golden_color", "golden_lang", "golden_final_t"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=f"{name} {k}")
    for k in PARAM_KEYS:
        assert got[k].dtype == want[k].dtype == np.float32
        g = want[f"grad_{k}"]
        np.testing.assert_allclose(got[f"grad_{k}"], g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=f"{name} grad_{k}")


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("goldens"))
    tmg.main(["--out", out, "--cpu"])
    return {n: dict(np.load(os.path.join(out, n + ".npz"))) for n in FIXTURES}


@pytest.mark.parametrize("name", FIXTURES)
def test_regenerated_goldens_hold_against_the_committed(regenerated, name):
    want = dict(np.load(os.path.join(GOLDEN_DIR, name + ".npz")))
    _hold(regenerated[name], want, name)


@pytest.mark.slow
def test_goldens_equal_the_jax_script_today(regenerated):
    """The JAX script's own render and gradients (about a minute on the
    CPU), against the port's and against the committed fixtures."""
    jmg = jax_script("make_goldens")
    base = jmg.scene_from_depth(32, 32, key=0)
    jax_recs = {
        "tabletop_dense": jmg.render_and_grads(
            base, novel_eye=(0.55, -0.55, 0.45), width=64, height=64),
        "tabletop_sparse": jmg.render_and_grads(
            jmg.degenerate_scene(base), novel_eye=(0.0, -0.75, 0.55),
            width=32, height=32)}
    for name, rec in jax_recs.items():
        rec = {k: np.asarray(v) for k, v in rec.items()}
        _hold(regenerated[name], rec, name)
        committed = dict(np.load(os.path.join(GOLDEN_DIR, name + ".npz")))
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(rec[k], committed[k])


def test_oracle_bound_is_float32_rounding():
    """The dense fixture rendered by the port's oracle in float64 from the
    committed inputs: inside this file's rule everywhere, and outside the
    JAX oracle's atol 1e-6 / rtol 1e-5 on some language elements, as the
    committed float32 frames carry XLA's rounding."""
    import torch

    from manigaussian_tpu_torch.ops import camera as cam
    from manigaussian_tpu_torch.ops.rasterizer_ref import rasterize_reference
    d = dict(np.load(os.path.join(GOLDEN_DIR, "tabletop_dense.npz")))
    h, w = int(d["height"]), int(d["width"])
    t = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=torch.float64)
    camera = cam.novel_camera_calib(t(d["intrinsic"]), t(d["c2w"]),
                                    float(d["znear"]), float(d["zfar"]), h, w)
    out = rasterize_reference(
        t(d["means3d"]), t(d["opacities"]), camera, w, h, (0.0, 0.0, 0.0),
        t(d["scales"]), t(d["rotations"]), t(d["shs"]),
        t(d["language_features"]))
    np.testing.assert_array_equal(out.radii.numpy(), d["golden_radii"])
    lang = out.language_feature.numpy()
    np.testing.assert_allclose(lang, d["golden_lang"], atol=1e-5, rtol=1e-4)
    assert not np.allclose(lang, d["golden_lang"], atol=1e-6, rtol=1e-5)
