"""The port's bench entry point (`manigaussian_tpu_torch/bench.py`, the twin
of the root `bench.py`) on the CPU at a micro size.

`--cpu --n 512 --size 32` prints the overflow line and then one JSON line
with the root bench's keys and `vs_baseline: null`. The bench's loss and
its six gradients equal `jax.grad` of the root bench's loss (its
`make_camera`, its `RasterizeConfig`, the JAX rasterizer on its default
Pallas route, in interpret mode on the CPU) on the same numpy scene, under
the rules of the port's rasterizer gradient tests
(tests/test_torch_renderer.py): the loss within 1e-4 relative, each
gradient atol 2e-4 / rtol 1e-3 with ≤ 2 % of its elements outside.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from manigaussian_tpu.ops import rasterizer as jrast
from manigaussian_tpu_torch import bench
from tests.helpers import assert_mostly_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_prints_the_root_bench_keys():
    proc = subprocess.run(
        [sys.executable, "-m", "manigaussian_tpu_torch.bench", "--cpu",
         "--n", "512", "--size", "32"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2
    over, res = json.loads(lines[0]), json.loads(lines[1])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["metric"] == "fwd_bwd_renders_per_s_per_chip_128px_65k"
    assert res["unit"] == "renders/s" and res["vs_baseline"] is None
    assert res["value"] > 0
    assert over["overflow_splats"] == 0 and over["overflow_gaussians"] >= 0
    assert over["gaussians"] == 512 and over["image"] == [32, 32]
    assert over["device"] == "cpu"


def test_scene_distributions():
    s = bench.make_scene(4096, torch.Generator().manual_seed(0))
    assert set(s) == set(bench.SCENE_KEYS)
    m = s["means"] - torch.tensor([0.0, 0.0, 1.6])
    assert m.min() >= -0.4 and m.max() <= 0.4 and m.abs().max() > 0.39
    assert s["scales"].min() >= 0.002 and s["scales"].max() <= 0.02
    assert torch.allclose(torch.linalg.norm(s["rotations"], dim=-1),
                          torch.ones(4096), atol=1e-6)
    assert s["opacities"].min() >= 0.2 and s["opacities"].max() <= 0.9
    assert s["shs"].shape == (4096, 4, 3)
    assert abs(float(s["shs"].std()) - 0.3) < 0.01
    assert s["lang"].shape == (4096, 3) and abs(float(s["lang"].std()) - 1) < 0.03
    again = bench.make_scene(4096, torch.Generator().manual_seed(0))
    assert all(torch.equal(s[k], again[k]) for k in s)


def test_loss_and_gradients_match_jax_grad_of_the_root_bench():
    n, size = 512, 32
    gen = torch.Generator().manual_seed(0)
    scene = bench.make_scene(n, gen)
    target = torch.rand(size, size, 3, generator=gen)
    loss, grads, extras = bench.loss_and_grads(
        scene, bench.make_camera(size), bench.bench_config(size), target)
    assert int(extras.overflow_splats) == 0

    cfg = jrast.RasterizeConfig(width=size, height=size, tile=16,
                                max_tiles_per_gaussian=16, tile_capacity=8192,
                                chunk=512, sh_degree=1)
    camera = jax_bench.make_camera(size)
    tgt = jnp.asarray(target.numpy())

    def jloss(means, scales, rotations, opacities, shs, lang):
        out, _ = jrast.rasterize(means, opacities, camera, cfg,
                                 (0.0, 0.0, 0.0), scales=scales,
                                 rotations=rotations, shs=shs,
                                 language_features=lang)
        return (jnp.sum((out.color - tgt) ** 2)
                + jnp.sum(out.language_feature ** 2))

    args = [jnp.asarray(scene[k].numpy()) for k in bench.SCENE_KEYS]
    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(6)))(*args)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k, g in zip(bench.SCENE_KEYS, jg):
        assert grads[k].shape == g.shape
        assert_mostly_close(grads[k].numpy(), np.asarray(g), atol=2e-4,
                            rtol=1e-3, max_frac=0.02, err_msg=f"grad {k}")
    assert all(math.isfinite(float(g.abs().sum())) for g in grads.values())


def test_bench_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(64, 16, iters=1)
