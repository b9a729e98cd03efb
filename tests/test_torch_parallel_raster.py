"""The port's tile-sharded renderer (`parallel/rasterizer_sharded.py`) over 2
and 4 gloo ranks on the CPU against JAX's `rasterize_sharded` on the
virtual CPU mesh (backend "xla", the plain blend on both sides), and against
the port's own one-process render.

Tolerances: images within 1e-5 of JAX's (atol and rtol: the features reach
|4|; ≤ 0.5 % of the pixels outside it: a splat on the 1/255 or T < 1e-4 threshold may flip between two
summation orders, the golden tests' rule) and bit for bit equal to the
port's one-process render (each tile is blended by the same code on the
same inputs); the gradients of every input under the golden tests' 2 % rule
(atol 2e-4·scale, rtol 1e-3, ≤ 2 % outside); the overflow counters equal,
also where `tile_capacity` drops splats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops import camera as jcam
from manigaussian_tpu.ops import rasterizer as jrast
from manigaussian_tpu.parallel.mesh import make_mesh
from manigaussian_tpu.parallel.rasterizer_sharded import \
    rasterize_sharded as jax_rasterize_sharded
from manigaussian_tpu_torch.ops.camera import novel_camera_calib
from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                   rasterize_batch)
from tests.helpers import assert_mostly_close, random_scene
from tests.torch_parallel_workers import raster_worker, run_ranks

KEYS = ("means3d", "opacities", "scales", "rotations", "shs",
        "language_features")
BG = (0.1, 0.2, 0.3)
# (name, image side, Gaussians, tile_capacity, chunk): the second drops
# splats past a small capacity in every crowded tile
SCENES = (("open", 32, 64, 64, 32), ("capacity8", 32, 96, 8, 8))


def _scene(name, size, n, cap, chunk, seed):
    sc = {k: np.array(v, np.float32) for k, v in random_scene(
        jax.random.PRNGKey(seed), n, spread=0.3).items()}
    sc["intr"] = np.array([[60.0, 0, size / 2], [0, 60.0, size / 2],
                           [0, 0, 1]], np.float32)
    sc["c2w"] = np.eye(4, dtype=np.float32)
    sc["target"] = np.random.default_rng(seed).uniform(
        size=(size, size, 3)).astype(np.float32)
    sc["bg"] = BG
    sc["cfg"] = dict(width=size, height=size, tile=16,
                     max_tiles_per_gaussian=16, tile_capacity=cap,
                     chunk=chunk, backend="xla")
    return sc


def _loss(color, lang, target):
    return ((color - target) ** 2).sum() + (lang ** 2).sum() * 0.1


def _jax_render(sc, n_dev):
    cfg = jrast.RasterizeConfig(**sc["cfg"])
    cam = jcam.novel_camera_calib(jnp.asarray(sc["intr"]),
                                  jnp.asarray(sc["c2w"]), 0.1, 4.0,
                                  cfg.height, cfg.width)
    mesh = make_mesh((n_dev,), ("tile",))
    target = jnp.asarray(sc["target"])

    def render(*xs):
        kw = dict(zip(KEYS[2:], xs[2:]))
        return jax_rasterize_sharded(mesh, xs[0], xs[1], cam, cfg, BG, **kw)

    def loss(*xs):
        out, _ = render(*xs)
        return _loss(out.color, out.language_feature, target)

    xs = [jnp.asarray(sc[k]) for k in KEYS]
    out, ext = jax.jit(render)(*xs)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(KEYS)))))(*xs)
    return out, ext, [np.asarray(g) for g in grads]


def _port_one_process(sc):
    cfg = RasterizeConfig(**sc["cfg"])
    cam = novel_camera_calib(torch.from_numpy(sc["intr"])[None],
                             torch.from_numpy(sc["c2w"])[None], 0.1, 4.0,
                             cfg.height, cfg.width)
    xs = [torch.from_numpy(sc[k])[None] for k in KEYS]
    out, ext = rasterize_batch(xs[0], xs[1], cam, cfg, BG, *xs[2:5], xs[5])
    return out, ext


@pytest.mark.parametrize("world", [2, 4])
def test_tile_sharded_render_matches_jax_rasterize_sharded(tmp_path, world):
    scenes = {name: _scene(name, size, n, cap, chunk, seed=3 + i)
              for i, (name, size, n, cap, chunk) in enumerate(SCENES)}
    run_ranks(raster_worker, world, (scenes, str(tmp_path)), timeout=150)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for name, sc in scenes.items():
        port = ranks[0][name]
        for other in ranks[1:]:   # every rank holds the same images and grads
            for k in ("color", "lang", "final_t"):
                assert torch.equal(other[name][k], port[k]), (name, k)
            for a, b in zip(other[name]["grads"], port["grads"]):
                assert torch.equal(a, b), name
        jout, jext, jgrads = _jax_render(sc, world)
        for k, j in (("color", jout.color), ("lang", jout.language_feature),
                     ("final_t", jout.final_t)):
            assert_mostly_close(port[k].numpy(), np.asarray(j), atol=1e-5,
                                rtol=1e-5, err_msg=f"{name} {k}")
        np.testing.assert_array_equal(port["radii"].numpy(),
                                      np.asarray(jout.radii))
        assert port["overflow_splats"] == int(jext.overflow_splats)
        assert port["overflow_gaussians"] == int(jext.overflow_gaussians)
        if name == "capacity8":
            assert port["overflow_splats"] > 0
        for key, a, b in zip(KEYS, port["grads"], jgrads):
            scale = max(float(np.abs(b).max()), 1e-6)
            assert_mostly_close(a.numpy(), b, atol=2e-4 * scale, rtol=1e-3,
                                max_frac=0.02, err_msg=f"{name} d{key}")
        one, one_ext = _port_one_process(sc)
        for k, o in (("color", one.color), ("lang", one.language_feature),
                     ("final_t", one.final_t)):
            assert torch.equal(port[k], o[0]), (name, k)
        assert port["overflow_splats"] == int(one_ext.overflow_splats)
