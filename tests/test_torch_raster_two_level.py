"""The rasterizer's two-level duplication (`small_rect_cap` > 0) in the port
against the JAX package, on the plain route (JAX `backend="xla"`, jitted;
the port's `"xla"`), at 64², 16² tiles, 256 Gaussians of which 12 have
big rects, r_cap 16, s 4.

Tolerances: image, features and transmittance within 1e-5 (atol and rtol)
but for 0.5 % of the elements, as the tile-sharded renderer's parity test
holds them (a splat on the T < 1e-4 latch may flip between two summation
orders); gradients under the golden tests' 2 % rule (2e-4 / 1e-3, 2 % of
the elements); overflow counters and per-tile counts exactly. Against the
port's single-level render, when the table holds every big Gaussian: bit
for bit (the same splat set in the same key order), also in a tile window
of the tile-sharded renderer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops import rasterizer as jrast
from manigaussian_tpu_torch.ops import camera as tcam
from manigaussian_tpu_torch.ops import gaussian_math as tgm
from manigaussian_tpu_torch.ops import rasterizer as trast
from tests.helpers import assert_mostly_close, make_camera
from tests.torch_port_helpers import to_np

BG = (0.0, 0.0, 0.0)
N, BIG = 256, 12
KEYS = ("means3d", "opacities", "scales", "rotations", "shs",
        "language_features")


def _scene(seed=11):
    rng = np.random.default_rng(seed)
    f = np.float32
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (N, 3)))
    scales[:BIG] = 0.22                                   # big rects
    q = rng.standard_normal((N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {"means3d": (np.array([0.0, 0.0, 2.0])
                        + 0.35 * rng.standard_normal((N, 3))).astype(f),
            "opacities": rng.uniform(0.05, 0.95, N).astype(f),
            "scales": scales.astype(f),
            "rotations": q.astype(f),
            "shs": (0.3 * rng.standard_normal((N, 4, 3))).astype(f),
            "language_features": rng.standard_normal((N, 3)).astype(f)}


BASE = dict(width=64, height=64, tile=16, max_tiles_per_gaussian=16,
            tile_capacity=512, chunk=64, sh_degree=1, backend="xla")


@pytest.fixture(scope="module")
def setup():
    scene = _scene()
    cam = make_camera(64, 64, focal=60.0)
    tc = tcam.Camera(*(torch.from_numpy(np.array(x)) for x in cam))
    return scene, cam, tc


def _jax(scene, cam, cfg):
    def loss(means, scales):
        out, ex = jrast.rasterize(
            means, jnp.asarray(scene["opacities"]), cam, cfg, BG,
            scales=scales, rotations=jnp.asarray(scene["rotations"]),
            shs=jnp.asarray(scene["shs"]),
            language_features=jnp.asarray(scene["language_features"]))
        return jnp.sum(out.color ** 2) + jnp.sum(out.final_t), (out, ex)
    (_, (out, ex)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(scene["means3d"]), jnp.asarray(scene["scales"]))
    return out, ex, grads


def _torch(scene, tc, cfg):
    p = {k: torch.from_numpy(scene[k]).requires_grad_() for k in KEYS}
    out, ex = trast.rasterize(p["means3d"], p["opacities"], tc, cfg, BG,
                              p["scales"], p["rotations"], p["shs"],
                              p["language_features"])
    loss = (out.color ** 2).sum() + out.final_t.sum()
    loss.backward()
    return out, ex, (p["means3d"].grad, p["scales"].grad)


def _tile_counts(scene, tc, cfg, tile_range=None):
    t = lambda k: torch.from_numpy(scene[k])[None]
    pre = tgm.preprocess(t("means3d"), t("opacities"),
                         tcam.Camera(*(f[None] for f in tc)), cfg.width,
                         cfg.height, cfg.tile, scales=t("scales"),
                         rotations=t("rotations"), shs=t("shs"))
    return trast.tile_lists(pre, cfg, tile_range)


@pytest.mark.parametrize("table", [64, 2])
def test_two_level_matches_jax(setup, table):
    """A table that holds every big Gaussian, and one that holds 2 of 12."""
    scene, cam, tc = setup
    jcfg = jrast.RasterizeConfig(**BASE, small_rect_cap=4, big_table_cap=table)
    tcfg = trast.RasterizeConfig(**BASE, small_rect_cap=4, big_table_cap=table)
    jout, jex, jgrads = _jax(scene, cam, jcfg)
    tout, tex, tgrads = _torch(scene, tc, tcfg)
    for f in ("color", "language_feature", "final_t"):
        assert_mostly_close(to_np(getattr(tout, f)),
                            np.asarray(getattr(jout, f)), atol=1e-5,
                            rtol=1e-5, err_msg=f)
    assert int(tex.overflow_gaussians) == int(jex.overflow_gaussians)
    assert int(tex.overflow_splats) == int(jex.overflow_splats)
    assert (int(tex.overflow_gaussians) > 0) == (table < BIG)
    counts = _tile_counts(scene, tc, tcfg)[2]
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jex.tile_counts))
    for name, a, b in zip(("means3d", "scales"), tgrads, jgrads):
        assert_mostly_close(a.numpy(), np.asarray(b), atol=2e-4, rtol=1e-3,
                            max_frac=0.02, err_msg=f"grad {name}")


def test_two_level_equals_single_level_bit_for_bit(setup):
    scene, _, tc = setup
    single = trast.RasterizeConfig(**BASE)
    two = single._replace(small_rect_cap=4, big_table_cap=64)
    s_out, s_ex, s_grads = _torch(scene, tc, single)
    t_out, t_ex, t_grads = _torch(scene, tc, two)
    assert int(s_ex.overflow_gaussians) == int(t_ex.overflow_gaussians) == 0
    for a, b in zip((*s_out, *s_grads), (*t_out, *t_grads)):
        assert torch.equal(a, b)
    # the same lists in every tile window of the tile-sharded renderer
    for window in ((0, 8), (5, 6), (8, 8)):
        sg, sl, sc = _tile_counts(scene, tc, single, window)[:3]
        tg, tl, tcnt = _tile_counts(scene, tc, two, window)[:3]
        assert torch.equal(sc, tcnt) and torch.equal(sl, tl)
        assert torch.equal(sg[sl], tg[tl])
        assert int(sc.sum()) > 0
