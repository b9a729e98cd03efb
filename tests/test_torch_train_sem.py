"""The port's `w_geo_sem_dyna` train step (the paper's full model) against the
JAX package on the CPU, and the train entry point of the semantic tier.

`update` on `micro_variant("w_geo_sem_dyna")` in fp32, dropout 0, the
dynamic field's warm-up gate at step 1, batch 2, from JAX parameters
converted one to one: three steps of jitted JAX `agent.update` and of the
port's `update` (each from JAX's state before it, as in
tests/test_torch_train.py) on the same batches and augmentation draws,
with JAX's `gt_embed` (its stub extractor + PCA) fed to both — the
embedding pipeline is held on its own (tests/test_torch_foundation.py), since a PCA sign flip
changes the cosine loss. The embed loss enters every step; the deformation
field reads the detached embedding, so its first layer is 3 inputs wider
than in `w_geo_dyna`.

Tolerances as tests/test_torch_train_dyna.py: every metric within
1e-4·max(1, |value|) step by step; parameters after the third LAMB step within
2e-5 + 1e-3 of their leaf's scale (NOISE_LEAF: LAMB's step bound).

Then the train CLI on `--cpu --synthetic --variant w_geo_sem_dyna`, with
the stub (no checkpoint: warned) and with the random-init SD VAE at a
64² feature size, each with a resume that rebuilds the same `gt_embed`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu import config as JC
from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu.models.foundation import (StubFeatureExtractor,
                                                extract_gt_embed)
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from tests.test_torch_train import MICRO, jax_draws
from tests.test_torch_train_dyna import NOISE_LEAF, make_dyna_batch
from tests.torch_port_helpers import (load_jax_train_state,
                                      random_flax_params, torch_config)

STEPS = 3
WARM_UP = 1
DYNA_INPUT = "neural_renderer.gs_model.deformation.lin_in.weight"


def micro_sem_cfg(variant="w_geo_sem_dyna"):
    cfg = JC.micro_variant(variant)
    m = cfg.method
    nr = dataclasses.replace(m.neural_renderer, next_mlp=dataclasses.replace(
        m.neural_renderer.next_mlp, warm_up=WARM_UP))
    return dataclasses.replace(cfg, method=dataclasses.replace(
        m, input_dropout=0.0, attn_dropout=0.0, neural_renderer=nr))


def make_sem_batch():
    batch = make_dyna_batch()
    batch["gt_embed"] = np.array(extract_gt_embed(
        jnp.asarray(batch["nerf_target_rgb"]), StubFeatureExtractor(), 3))
    return batch


@pytest.fixture(scope="module")
def trajectories():
    cfg = micro_sem_cfg()
    nr = cfg.method.neural_renderer
    assert nr.foundation_model_name == "diffusion" and nr.use_dynamic_field
    jagent = JAgent(cfg)
    batch = make_sem_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    nerf = {k: jb[k] for k in batch if k.startswith("nerf_")}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, action=jb["action"],
        gt_embed=jb["gt_embed"], seed=3, **nerf)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))

    state = TrainState(jnp.zeros((), jnp.int32), params, jagent.opt.init(params))
    update = jax.jit(jagent.update)
    jm, tm = [], []
    gen = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        key = jax.random.PRNGKey(30 + i)
        load_jax_train_state(tagent, state)
        state, metrics = update(state, jb, key)
        jm.append({k: float(v) for k, v in metrics.items()})
        out = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
        tm.append({k: float(v) for k, v in out.items()})
    return cfg, params, state, tagent, jm, tm


def test_the_deformation_field_reads_the_embedding(trajectories):
    _, params, _, tagent, _, _ = trajectories
    gs = params["params"]["neural_renderer"]["gs_model"]
    wide = tagent.qfn.state_dict()[DYNA_INPUT].shape[1]
    assert gs["deformation"]["Dense_0"]["kernel"].shape[0] == wide
    dyna = TAgent(torch_config(JC.micro_variant("w_geo_dyna")), device="cpu")
    assert wide == dyna.qfn.state_dict()[DYNA_INPUT].shape[1] + 3
    sd = convert.qfunction_state_dict(params)
    assert set(sd) == set(tagent.qfn.state_dict())


@pytest.mark.parametrize("metric", ["total_loss", "rgb_loss", "embed_loss",
                                    "dyna_loss", "bc_loss"])
def test_update_follows_jax_trajectory(trajectories, metric):
    _, _, _, _, jm, tm = trajectories
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j)
        assert np.isfinite(t[metric])
        assert abs(t[metric] - j[metric]) <= 1e-4 * max(1.0, abs(j[metric])), (
            i, metric, t[metric], j[metric])


def test_embed_loss_enters_the_total_every_step(trajectories):
    cfg, _, _, _, jm, tm = trajectories
    m = cfg.method
    nr = m.neural_renderer
    for i, (j, t) in enumerate(zip(jm, tm)):
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), (i, k)
        assert t["embed_loss"] != 0.0 and j["embed_loss"] != 0.0
        expect = m.lambda_bc * t["bc_loss"] + nr.lambda_nerf * (
            t["rgb_loss"] + nr.lambda_embed * t["embed_loss"]
            + (nr.lambda_dyna * t["dyna_loss"] if i >= WARM_UP else 0.0))
        assert abs(t["total_loss"] - expect) <= 1e-5 * max(1.0, abs(expect)), i


def test_parameters_after_three_steps_match(trajectories):
    cfg, params, state, tagent, _, _ = trajectories
    expect = convert.qfunction_state_dict(jax.device_get(state.params))
    start = convert.qfunction_state_dict(params)
    got = tagent.qfn.state_dict()
    assert set(got) == set(expect)
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
    # the deformation field's embedding columns trained once the gate opened
    assert not torch.equal(got[DYNA_INPUT], start[DYNA_INPUT])


@pytest.mark.parametrize("tower", ["stub", "random-init"])
def test_train_entry_point_sem_dyna_on_the_cpu_with_resume(tmp_path,
                                                           monkeypatch, tower):
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.data.pipeline import BatchIterator
    from manigaussian_tpu_torch.models import foundation
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints

    built, embeds = [], []
    create = foundation.create_feature_extractor
    next_batch = BatchIterator.__next__

    def recording_create(*args, **kwargs):
        built.append(create(*args, **kwargs))
        return built[-1]

    def recording_next(self):
        batch = next_batch(self)
        embeds.append(batch["gt_embed"])
        return batch

    monkeypatch.setattr(foundation, "create_feature_extractor",
                        recording_create)
    monkeypatch.setattr(BatchIterator, "__next__", recording_next)
    monkeypatch.setattr(foundation, "FEATURE_HW", 64)
    demos, logs = str(tmp_path / "demos"), str(tmp_path / "logs")
    argv = ["--cpu", "--variant", "w_geo_sem_dyna", "--demo-root", demos,
            "--logdir", logs, "--synthetic", *MICRO,
            "method.neural_renderer.next_mlp.warm_up=1"]
    if tower == "random-init":
        argv.append("method.neural_renderer.foundation_checkpoint=random-init")
        first = train_cli.main([*argv, "framework.training_iterations=2"])[0]
        assert isinstance(built[0], foundation.SDVaeFeatureExtractor)
    else:
        with pytest.warns(UserWarning, match="diffusion"):
            first = train_cli.main([*argv, "framework.training_iterations=2"])[0]
        assert isinstance(built[0], foundation.StubFeatureExtractor)
    assert built[0].device.type == "cpu"
    run = str(tmp_path / "logs" / "seed0")
    assert list_checkpoints(run) == [1]
    assert all(np.isfinite(v) for v in first.values())
    assert first["embed_loss"] != 0.0 and first["dyna_loss"] > 0.0
    with open(f"{run}/train_data.csv") as f:
        assert "embed_loss" in f.readline().strip().split(",")
    n_first = len(embeds)
    second = train_cli.main([*argv, "framework.training_iterations=3",
                             "framework.load_existing_weights=true"])[0]
    assert list_checkpoints(run) == [1, 2]
    assert np.isfinite(second["total_loss"]) and second["embed_loss"] != 0.0
    # the resumed run rebuilt the frozen tower: its iterator starts from the
    # same seed, so its first batch carries the same ground-truth embedding
    assert len(built) == 2 and len(embeds) == n_first + 2
    assert embeds[0].shape == (1, 32, 32, 3) and embeds[0].dtype == np.float32
    np.testing.assert_array_equal(embeds[n_first], embeds[0])
