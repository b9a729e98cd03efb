"""The port's GNFACTOR_BC agent (the generalizable-NeRF baseline) against the
JAX package on the CPU, and its registry entry, recon render, checkpoint,
eval and train entry point.

`update` on `micro_variant("w_geo")` with `method.name="GNFACTOR_BC"` in
fp32, dropout 0, the NeRF cut to 8 coarse / 6 fine (2 of them around the
depth) samples on 32 rays a sample, batch 2, from JAX parameters converted
one to one: three steps of jitted JAX `agent.update` and of the port's
`update`, with JAX's augmentation draws fed to the port, with and without a
ground-truth embedding. The NeRF's draws are fed to both packages as in
tests/test_torch_nerf_renderer.py (`feed_draws`: the port's `sample_draws`
and, through a monkeypatch of the JAX module's global `jax`, JAX's
`jax.random` calls return one numpy table; the jitted JAX step bakes it in
when it traces, so every step of both packages renders with the same
draws).

Tolerances as tests/test_torch_train.py: every metric within
1e-4·max(1, |value|) step by step; parameters after three LAMB steps within
2e-5 + 1e-3 of their leaf's scale (NOISE_LEAF: LAMB's step bound).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu.agents.registry import create_agent as j_create_agent
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.registry import create_agent
from manigaussian_tpu_torch.rendering.nerf_renderer import (
    IMAGE_CHUNK, GNFactorNeRFRenderer)
from tests.test_torch_nerf_renderer import feed_draws, make_draws
from tests.test_torch_train import (MICRO, NOISE_LEAF, jax_draws, make_batch,
                                    micro_cfg)
from tests.torch_port_helpers import random_flax_params, torch_config

STEPS = 3
NERF = dict(n_coarse=8, n_fine=6, n_fine_depth=2, ray_chunk_size=32)
NERF_OVERRIDES = [f"method.neural_renderer.{k}={v}" for k, v in NERF.items()]


def gnf_cfg():
    cfg = micro_cfg()
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, name="GNFACTOR_BC", neural_renderer=dataclasses.replace(
            cfg.method.neural_renderer, **NERF)))


def nerf_draws(cfg, seed=11, b=2):
    nr = cfg.method.neural_renderer
    return make_draws(seed, b, nr.ray_chunk_size, nr.n_coarse, nr.n_fine,
                      nr.n_fine_depth, nr.image_width * nr.image_height)


def image_draws(cfg, seed=12):
    nr = cfg.method.neural_renderer
    d = make_draws(seed, 1, IMAGE_CHUNK, nr.n_coarse, nr.n_fine,
                   nr.n_fine_depth, 1)
    del d["ray_idx"]
    return d


def gnf_batch(with_embed: bool):
    batch = make_batch()
    if with_embed:
        rng = np.random.default_rng(5)
        batch["gt_embed"] = rng.standard_normal(
            (2, 32, 32, 3)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=["gt_embed", "no_gt_embed"])
def trajectories(request):
    with_embed = request.param == "gt_embed"
    cfg = gnf_cfg()
    jagent = j_create_agent(cfg)
    batch = gnf_batch(with_embed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, nerf_target_rgb=jb["nerf_target_rgb"],
        nerf_target_pose=jb["nerf_target_pose"],
        nerf_target_intrinsic=jb["nerf_target_intrinsic"],
        gt_embed=jb.get("gt_embed"), seed=3)
    tagent = create_agent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))

    state = TrainState(jnp.zeros((), jnp.int32), params, jagent.opt.init(params))
    jm, tm = [], []
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        feed_draws(mp, nerf_draws(cfg))
        update = jax.jit(jagent.update)
        for i in range(STEPS):
            key = jax.random.PRNGKey(20 + i)
            state, metrics = update(state, jb, key)
            jm.append({k: float(v) for k, v in metrics.items()})
            out = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
            tm.append({k: float(v) for k, v in out.items()})
    return cfg, with_embed, params, state, tagent, jm, tm


def test_update_follows_jax_trajectory(trajectories):
    cfg, with_embed, _, _, _, jm, tm = trajectories
    m = cfg.method
    nr = m.neural_renderer
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j)
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), (
                i, k, t[k], j[k])
        assert t["dyna_loss"] == 0.0 and t["overflow_splats"] == 0.0
        assert (t["embed_loss"] != 0.0) == with_embed
        # the NeRF's losses (rgb and, with gt_embed, embed: each already
        # scaled by its lambda) enter through lambda_nerf
        expect = (m.lambda_bc * t["bc_loss"]
                  + nr.lambda_nerf * (t["rgb_loss"] + t["embed_loss"]))
        assert abs(t["total_loss"] - expect) <= 1e-5 * max(1.0, abs(expect))
    assert all(np.isfinite(v) for m_ in tm for v in m_.values())
    assert tm[0]["total_loss"] != tm[-1]["total_loss"]


def test_parameters_after_three_steps_match(trajectories):
    cfg, _, params, state, tagent, _, _ = trajectories
    expect = convert.qfunction_state_dict(jax.device_get(state.params))
    start = convert.qfunction_state_dict(params)
    got = tagent.qfn.state_dict()
    assert set(got) == set(expect)
    assert any(k.startswith("neural_renderer.nerf.mlp.") for k in got)
    for k, v in expect.items():
        ref = v.numpy()
        if k == NOISE_LEAF:
            w0 = np.abs(start[k].numpy()).max()
            for end in (got[k].numpy(), ref):
                assert np.abs(end - start[k].numpy()).max() \
                    <= 1.05 * STEPS * cfg.method.lr * w0
            continue
        tol = 2e-5 + 1e-3 * np.abs(ref).max()
        np.testing.assert_allclose(got[k].numpy(), ref, atol=tol, rtol=0,
                                   err_msg=k)
    # the NeRF's MLP trained
    name = "neural_renderer.nerf.mlp.lin_out.weight"
    assert not torch.equal(got[name], start[name])


def test_registry_builds_the_nerf_agent():
    cfg = torch_config(gnf_cfg())
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, use_neural_rendering=False,
        neural_renderer=dataclasses.replace(cfg.method.neural_renderer,
                                            use_dynamic_field=True)))
    agent = create_agent(cfg, device="cpu")
    m = agent.cfg.method
    assert m.use_neural_rendering and m.neural_renderer.renderer_type == "nerf"
    assert not m.neural_renderer.use_dynamic_field
    r = agent.qfn.neural_renderer
    assert isinstance(r, GNFactorNeRFRenderer)
    # the NeRF's MLP reads neural_renderer.mlp (the regressor does not)
    mlp = m.neural_renderer.mlp
    assert len(r.nerf.mlp.blocks) == mlp.n_blocks
    assert r.nerf.mlp.lin_in.weight.shape[0] == mlp.d_hidden
    assert len(r.nerf.mlp.lin_z) == min(mlp.combine_layer, mlp.n_blocks)
    assert r.nerf.mlp.lin_out.weight.shape[0] == 4 + m.neural_renderer.d_embed
    jr = j_create_agent(gnf_cfg()).cfg.method
    assert m.neural_renderer == torch_config(
        dataclasses.replace(gnf_cfg(), method=jr)).method.neural_renderer


def test_render_for_vis_matches_jax(monkeypatch):
    """The recon render (no target image; the target pose): the NeRF's
    full image of sample 0 from the policy's voxel features, deterministic,
    with one set of draws for every chunk (fed to both packages)."""
    cfg = gnf_cfg()
    jagent = j_create_agent(cfg)
    batch = gnf_batch(False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, nerf_target_rgb=jb["nerf_target_rgb"],
        nerf_target_pose=jb["nerf_target_pose"],
        nerf_target_intrinsic=jb["nerf_target_intrinsic"], seed=4)
    tagent = create_agent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))
    feed_draws(monkeypatch, nerf_draws(cfg), image_draws(cfg))
    theirs = jagent.render_for_vis(params, jb)
    ours = tagent.render_for_vis(batch)
    assert ours.render_novel.shape == (1, 32, 32, 3)
    assert ours.next_render_novel is None and ours.render_embed is None
    got, want = ours.render_novel.numpy(), np.asarray(theirs.render_novel)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_train_cli_run_resume_recon_panel_and_eval(tmp_path):
    """The train entry point with method.name=GNFACTOR_BC at micro size:
    2 steps (the recon panel at step 0), a resume to 3; then the eval entry
    point on the mock env restores the GNFACTOR_BC checkpoint."""
    from manigaussian_tpu_torch import eval as eval_cli
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints
    demos, logs = str(tmp_path / "demos"), str(tmp_path / "logs")
    argv = ["--cpu", "--demo-root", demos, "--logdir", logs, "--synthetic",
            *MICRO, *NERF_OVERRIDES, "method.name=GNFACTOR_BC"]
    first = train_cli.main([*argv, "framework.training_iterations=2"])[0]
    run = str(tmp_path / "logs" / "seed0")
    assert list_checkpoints(run) == [1]
    assert all(np.isfinite(v) for v in first.values())
    assert first["dyna_loss"] == 0.0 and first["rgb_loss"] > 0.0
    assert os.path.isfile(os.path.join(run, "recon", "0.png"))
    with open(f"{run}/train_data.csv") as f:
        header = f.readline().strip().split(",")
    for head in ("total_loss", "rgb_loss", "embed_loss", "psnr"):
        assert head in header
    state = torch.load(os.path.join(run, "weights", "1", "state_dict.pt"),
                       weights_only=True)
    assert any(k.startswith("neural_renderer.nerf.") for k in state)
    second = train_cli.main([*argv, "framework.training_iterations=3",
                             "framework.load_existing_weights=true"])[0]
    assert list_checkpoints(run) == [1, 2]
    assert np.isfinite(second["total_loss"])
    rows = eval_cli.main(["--cpu", "--logdir", run, "--demo-root", demos,
                          "--eval-type", "last", "--episodes", "1",
                          "--episode-length", "3"])
    assert len(rows) == 1 and int(rows[0]["step"]) == 2
    assert np.isfinite(rows[0]["eval_envs/return"])


def test_recon_panel_failure_does_not_stop_training(tmp_path, monkeypatch,
                                                    capsys):
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent

    def broken(self, batch):
        raise RuntimeError("no render")

    monkeypatch.setattr(ManiGaussianBCAgent, "render_for_vis", broken)
    argv = ["--cpu", "--demo-root", str(tmp_path / "d"), "--logdir",
            str(tmp_path / "l"), "--synthetic", *MICRO, *NERF_OVERRIDES,
            "method.name=GNFACTOR_BC", "framework.training_iterations=1"]
    out = train_cli.main(argv)[0]
    assert np.isfinite(out["total_loss"])
    assert "recon panel failed at 0" in capsys.readouterr().out
