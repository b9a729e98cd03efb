"""The port's renderer pieces against the JAX package on the CPU: cameras,
the per-Gaussian preprocess, the tile binning (keys, tile lists) and the
untiling, and `rasterize` against the pinned golden frames and gradients
(tests/goldens/*.npz, the JAX golden tests' fixtures).

Tolerances: camera matrices and preprocess outputs 1e-5 relative (fp32, the
same formulas; the JAX side asks for HIGHEST-precision products), integer
outputs (radii, tile rects, the binned lists) exact. Golden frames and
gradients under the rules of tests/test_goldens.py (`assert_mostly_close`:
frames atol 1e-4 / rtol 1e-3 with ≤ 0.5 % outside, gradients atol 2e-4 /
rtol 1e-3 with ≤ 2 % outside), with the loss weights drawn by jax.random
exactly as tests/test_goldens.py draws them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops import camera as jcam
from manigaussian_tpu.ops import gaussian_math as jgm
from manigaussian_tpu.ops import rasterizer as jrast
from manigaussian_tpu_torch.ops import camera as tcam
from manigaussian_tpu_torch.ops import gaussian_math as tgm
from manigaussian_tpu_torch.ops import rasterizer as trast
from tests.helpers import assert_mostly_close, random_scene
from tests.test_goldens import (FIXTURES, PARAM_KEYS, load_fixture,
                                production_cfg)
from tests.torch_port_helpers import assert_close, to_np


def _cameras(seed=0, b=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    intr = np.zeros((b, 3, 3), np.float32)
    intr[:, 0, 0] = rng.uniform(40, 80, b)
    intr[:, 1, 1] = rng.uniform(40, 80, b)
    intr[:, 0, 2] = rng.uniform(20, 40, b)
    intr[:, 1, 2] = rng.uniform(20, 30, b)
    intr[:, 2, 2] = 1.0
    c2w = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        c2w[i, :3, :3] = q * np.sign(np.linalg.det(q))
        c2w[i, :3, 3] = rng.standard_normal(3)
    return intr, c2w, h, w


def test_novel_camera_calib_matches_jax():
    intr, c2w, h, w = _cameras()
    jc = jcam.novel_camera_calib_batch(jnp.asarray(intr), jnp.asarray(c2w),
                                       0.1, 4.0, h, w)
    tc = tcam.novel_camera_calib(torch.from_numpy(intr), torch.from_numpy(c2w),
                                 0.1, 4.0, h, w)
    for name, a, b in zip(tc._fields, tc, jc):
        assert_close(a, b, 1e-5, err_msg=name)
    bounds = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)
    xyz = np.random.default_rng(1).uniform(-0.5, 1.5, (10, 3)).astype(np.float32)
    assert_close(tcam.world_to_canonical(torch.from_numpy(xyz), bounds),
                 jcam.world_to_canonical(jnp.asarray(xyz), bounds), 1e-6)


@pytest.fixture(scope="module")
def scene():
    s = {k: np.asarray(v) for k, v in
         random_scene(jax.random.PRNGKey(3), 300, spread=0.6).items()}
    cam = jcam.novel_camera_calib(
        jnp.array([[60.0, 0, 32.0], [0, 60.0, 32.0], [0, 0, 1.0]]),
        jnp.eye(4), 0.1, 4.0, 64, 64)
    tc = tcam.Camera(*(torch.from_numpy(np.asarray(f)) for f in cam))
    return s, cam, tc


def test_preprocess_matches_jax(scene):
    s, cam, tc = scene
    jp = jgm.preprocess(jnp.asarray(s["means3d"]), jnp.asarray(s["opacities"]),
                        cam, 64, 64, 16, scales=jnp.asarray(s["scales"]),
                        rotations=jnp.asarray(s["rotations"]),
                        shs=jnp.asarray(s["shs"]), sh_degree=1)
    t = lambda k: torch.from_numpy(s[k])
    tp = tgm.preprocess(t("means3d"), t("opacities"), tc, 64, 64, 16,
                        scales=t("scales"), rotations=t("rotations"),
                        shs=t("shs"), sh_degree=1)
    for name in ("means2d", "depths", "conic", "opacity", "rgb"):
        assert_close(getattr(tp, name), getattr(jp, name), 1e-5, err_msg=name)
    for name in ("radii", "rect_min", "rect_max", "valid", "tiles_touched"):
        np.testing.assert_array_equal(to_np(getattr(tp, name)),
                                      np.asarray(getattr(jp, name), np.float32),
                                      err_msg=name)
    assert bool(jp.valid.any()) and not bool(jp.valid.all())  # culls happen


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_and_covariances_match_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.standard_normal((20, (deg + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.standard_normal((20, 3)).astype(np.float32)
    dirs[0] = 0.0                                   # the 1e-8 guard
    (ja, jm), (ta, tm) = (jgm.eval_sh(jnp.asarray(sh), deg, jnp.asarray(dirs)),
                          tgm.eval_sh(torch.from_numpy(sh), deg,
                                      torch.from_numpy(dirs)))
    assert_close(ta, ja, 1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    scale = rng.uniform(0.01, 0.1, (20, 3)).astype(np.float32)
    q = rng.standard_normal((20, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    assert_close(tgm.build_cov3d(torch.from_numpy(scale), torch.from_numpy(q)),
                 jgm.build_cov3d(jnp.asarray(scale), jnp.asarray(q)), 1e-6)


def test_tile_lists_and_untile_match_jax(scene):
    s, cam, tc = scene
    cfg = jrast.RasterizeConfig(width=64, height=64, tile=16,
                                max_tiles_per_gaussian=4, tile_capacity=64,
                                chunk=32)
    jp = jgm.preprocess(jnp.asarray(s["means3d"]), jnp.asarray(s["opacities"]),
                        cam, 64, 64, 16, scales=jnp.asarray(s["scales"]),
                        rotations=jnp.asarray(s["rotations"]),
                        shs=jnp.asarray(s["shs"]))
    sk, sg, ov_g, nt = jrast._build_keys(jp, cfg)
    jg, jl, jc, ov_s = jrast._tile_gather(sk, sg, nt, cfg.tile_capacity)
    t = lambda k: torch.from_numpy(s[k])[None]
    tp = tgm.preprocess(t("means3d"), t("opacities"),
                        tcam.Camera(*(f[None] for f in tc)), 64, 64, 16,
                        scales=t("scales"), rotations=t("rotations"), shs=t("shs"))
    tcfg = trast.RasterizeConfig(*cfg[:6])
    gidx, in_list, counts, tov_s, tov_g = trast.tile_lists(tp, tcfg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(in_list.numpy(), np.asarray(jl))
    live = np.asarray(jl)
    np.testing.assert_array_equal(gidx.numpy()[live], np.asarray(jg)[live])
    assert int(tov_s) == int(ov_s) > 0 and int(tov_g) == int(ov_g) > 0

    img = np.random.default_rng(0).standard_normal((16, 256, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trast._untile(torch.from_numpy(img), tcfg, 1)[0].numpy(),
        np.asarray(jrast._untile(jnp.asarray(img), cfg)))


def _torch_render(d, camera, backend, params=None):
    h, w = int(d["height"]), int(d["width"])
    cfg = trast.RasterizeConfig(*production_cfg(d, backend)[:8])
    tc = tcam.Camera(*(torch.from_numpy(np.asarray(f)) for f in camera))
    p = params or {k: torch.from_numpy(d[k]) for k in PARAM_KEYS}
    return trast.rasterize(p["means3d"], p["opacities"], tc, cfg, (0.0, 0.0, 0.0),
                           p["scales"], p["rotations"], p["shs"],
                           p["language_features"]), (h, w)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("name", FIXTURES)
def test_rasterize_matches_golden_frames(name, backend):
    d, camera, _ = load_fixture(name)
    (out, extras), _ = _torch_render(d, camera, backend)
    assert int(extras.overflow_splats) == 0 and int(extras.overflow_gaussians) == 0
    for field, key in (("color", "golden_color"),
                       ("language_feature", "golden_lang"),
                       ("final_t", "golden_final_t")):
        assert_mostly_close(to_np(getattr(out, field)), d[key], atol=1e-4,
                            rtol=1e-3, err_msg=f"{name}/{backend} {field}")
    np.testing.assert_array_equal(out.radii.numpy(), d["golden_radii"])


@pytest.mark.parametrize("name", FIXTURES)
def test_rasterize_grads_match_golden(name):
    d, camera, weights = load_fixture(name)
    wc, wl, wt = (torch.from_numpy(np.asarray(x)) for x in weights)
    params = {k: torch.from_numpy(d[k]).requires_grad_() for k in PARAM_KEYS}
    (out, _), _ = _torch_render(d, camera, "pallas", params)
    loss = ((out.color.reshape(-1, 3) * wc).sum()
            + (out.language_feature.reshape(-1, 3) * wl).sum()
            + (out.final_t.reshape(-1) * wt).sum())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(d["loss"]), rtol=1e-4)
    for k in PARAM_KEYS:
        assert_mostly_close(params[k].grad.numpy(), d[f"grad_{k}"], atol=2e-4,
                            rtol=1e-3, max_frac=0.02, err_msg=f"{name} grad_{k}")
