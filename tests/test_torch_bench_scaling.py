"""The port's scaling twin (`python -m manigaussian_tpu_torch.bench_scaling`)
and the collective byte counter of `parallel/distributed.py`, on the CPU
with two gloo ranks at a small size (2,048 Gaussians, 32² images, JAX's
tiny config for the DP rows).

The rows carry the JAX script's `metric` / `method` names and keys; the
render comm model's bytes equal a reckoning from the shapes; the DP step's
all-reduce bytes equal the port's own reckoning from its parameters and
metrics; no TPU figure is a default. JAX's HLO count of the same render is
computed beside the port's and printed (`-s`), not required to be equal:
XLA keeps only what the loss needs (the means' gradient, the color), the
port gathers color, features and transmittance and passes the gradient
back without a collective.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from manigaussian_tpu_torch import bench_scaling as BS
from manigaussian_tpu_torch.parallel import distributed as D

N, SIZE = 2048, 32
JAX_KEYS = {
    "strong_wallclock": {"metric", "method", "devices", "value",
                         "efficiency_vs_1", "core_share_adjusted_efficiency",
                         "platform_limited", "backend", "n_gaussians", "size",
                         "platform", "processes"},
    "weak_wallclock": {"metric", "method", "devices", "value",
                       "efficiency_vs_1", "core_share_adjusted_efficiency",
                       "platform_limited", "platform", "processes"},
    "comm_model": {"metric", "method", "devices", "collective_bytes",
                   "total_collective_bytes", "t_comm_no_overlap_ms",
                   "t_comp_measured_ms"},
}


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_timed_rows_have_jax_names(tmp_path):
    out = str(tmp_path / "s.jsonl")
    BS.main(["--cpu", "2", "--n", str(N), "--size", str(SIZE), "--iters",
             "2", "--weak", "--train-step", "--out", out])
    rows = _rows(out)
    assert [(r["metric"], r["devices"]) for r in rows] == [
        ("rays_per_s_fwd_bwd", 1), ("rays_per_s_fwd_bwd", 2),
        ("rays_per_s_per_device_weak", 1), ("rays_per_s_per_device_weak", 2),
        ("dp_train_steps_per_s", 1), ("dp_train_steps_per_s", 2)]
    for r in rows:
        assert JAX_KEYS[r["method"]] <= set(r)
        assert r["value"] > 0 and r["platform"] == "cpu"
        assert r["platform_limited"] == (r["devices"] > 1)
    assert rows[-1]["global_batch"] == 2


def test_render_comm_model_bytes_equal_the_reckoning(tmp_path):
    out = str(tmp_path / "c.jsonl")
    BS.main(["--cpu", "2", "--n", str(N), "--size", str(SIZE), "--iters",
             "1", "--comm-model", "--out", out])
    (row,) = _rows(out)
    assert row["metric"] == "render_comm_model" and row["devices"] == 2
    # replicate's backward: the means' gradient (the one input needing a
    # gradient), and the overflow counter (int64); the patch gather: color
    # 3, features 3 and transmittance 1 float32 a pixel
    assert row["collective_bytes"] == {
        "all-reduce": 4 * 3 * N + 8, "all-gather": 4 * 7 * SIZE * SIZE,
        "reduce-scatter": 0, "collective-permute": 0}
    assert row["t_comp_source"] == "D=1, this run"
    assert row["nvlink_bw_bytes_per_s"] == BS.NVLINK_BW_BYTES_PER_S
    t_comm = row["total_collective_bytes"] / 2 / BS.NVLINK_BW_BYTES_PER_S
    assert row["t_comm_no_overlap_ms"] == pytest.approx(t_comm * 1e3,
                                                        abs=1e-4)


def test_dp_comm_model_all_reduce_equals_parameters_and_metrics(tmp_path):
    args = BS.parse_args(["--comm-model", "--train-step", "--iters", "1",
                          "--n", str(N), "--size", str(SIZE), "--out",
                          str(tmp_path / "t.jsonl")])
    D.spawn_local(BS._spawned_rank, 2, (2, args, BS.tiny_config()))
    rows = _rows(args.out)
    assert [r["metric"] for r in rows] == ["render_comm_model",
                                           "dp_train_step_comm_model"]
    row = rows[1]
    assert JAX_KEYS["comm_model"] | {"param_bytes"} <= set(row)
    assert row["collective_bytes"]["all-reduce"] == \
        row["reckoned_all_reduce_bytes"]
    assert row["param_bytes"] > 0 and row["metric_bytes"] >= 8 * 5
    assert row["collective_bytes"]["all-gather"] == 0


def test_no_tpu_figure_and_the_counter_is_off_by_default():
    args = BS.parse_args([])
    assert args.tcomp_render_ms is None and args.tcomp_step_ms is None
    assert args.out.startswith("build")
    assert BS.NVLINK_BW_BYTES_PER_S == 450e9
    assert D._counts is None
    with D.count_collective_bytes() as outer:
        with D.count_collective_bytes() as inner:
            D._count("all-reduce", torch.zeros(3))
        assert inner["all-reduce"] == 12 and outer["all-reduce"] == 0
    assert D._counts is None


def test_jax_hlo_count_beside_the_ports():
    """JAX's HLO count of the same D = 2 render (its `bench_scaling.py`'s
    `_collective_bytes`, the plain route on 2 of the CPU devices), printed
    beside the port's reckoning."""
    import bench as B
    import bench_scaling as JS
    from manigaussian_tpu.ops.rasterizer import RasterizeConfig
    from manigaussian_tpu.parallel.mesh import make_mesh
    from manigaussian_tpu.parallel.rasterizer_sharded import \
        rasterize_sharded
    cfg = RasterizeConfig(width=SIZE, height=SIZE, tile=16,
                          max_tiles_per_gaussian=16, tile_capacity=512,
                          chunk=256, sh_degree=1, backend="xla")
    means, scales, rotations, opacities, shs, lang = B.make_scene(
        jax.random.PRNGKey(0), N)
    cam = B.make_camera(SIZE)
    tgt = jax.random.uniform(jax.random.PRNGKey(1), (SIZE, SIZE, 3))
    mesh = make_mesh((2,), ("tile",))

    def loss(m):
        out, _ = rasterize_sharded(mesh, m, opacities, cam, cfg, (0., 0., 0.),
                                   scales=scales, rotations=rotations,
                                   shs=shs, language_features=lang)
        return jnp.sum((out.color - tgt) ** 2)

    hlo = jax.jit(jax.grad(loss)).lower(means).compile().as_text()
    jax_bytes = JS._collective_bytes(hlo)
    print(json.dumps({"n": N, "size": SIZE, "jax_hlo": jax_bytes,
                      "port": {"all-reduce": 4 * 3 * N + 8,
                               "all-gather": 4 * 7 * SIZE * SIZE}}))
    assert jax_bytes["all-reduce"] == 4 * 3 * N   # the means' gradient
