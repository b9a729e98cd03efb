"""`method.optimizer="adam"` in the port: `utils/optimizers.AdamW` against
`optax.chain(clip_by_global_norm, adamw)`, the train step with it against
the JAX package's, its checkpoint and its replication over ranks.

Tolerances: AdamW against optax over 5 steps on seeded fp32 leaves, with
and without the warmup-cosine schedule, parameters and both moments within
1e-6 relative to each leaf's scale (the two differ only in the rounding of
1 − b^count and of the schedule, both a few ulps of fp32). The micro
`w_geo` trajectory (two steps of JAX's jitted `update` and of the port's,
each port step from JAX's parameters, moments and count before it, fp32,
dropout 0, JAX's augmentation draws fed to the port) at
test_torch_train.py's rule: every metric within 1e-4·max(1, |value|). The
checkpoint and the broadcast: bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu.agents.bc_agent import TrainState
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from manigaussian_tpu_torch.agents.bc_agent import make_optimizer
from manigaussian_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
from manigaussian_tpu_torch.utils.optimizers import (AdamW, Lamb,
                                                     warmup_cosine_schedule)
from tests.test_torch_train import jax_draws, make_batch, micro_cfg
from tests.torch_parallel_workers import adam_replicate_worker, run_ranks
from tests.torch_port_helpers import (load_jax_train_state,
                                      random_flax_params, torch_config)

SHAPES = [(5, 3), (7,), (2, 2, 2), (4,)]


def _adam_state(state):
    """The ScaleByAdamState inside an optax chain's state."""
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError("no adam state")


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax(schedule):
    rng = np.random.default_rng(0)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ps[3][:] = 0.0
    grads = [[(3.0 * rng.standard_normal(s)).astype(np.float32)
              for s in SHAPES] for _ in range(5)]
    grads[2][1][:] = 0.0                           # a zero gradient leaf
    lr, wd, clip = 2e-3, 1e-4, 5.0
    if schedule:
        jlr = optax.warmup_cosine_decay_schedule(0.0, lr, 2, 5)
        tlr = warmup_cosine_schedule(lr, 2, 5)
    else:
        jlr = tlr = lr
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adamw(jlr, weight_decay=wd))
    jp = [jnp.asarray(p) for p in ps]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    adam = AdamW(tp, tlr, weight_decay=wd, grad_clip_norm=clip)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        norm = adam.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(x) for x in g])), rtol=1e-6)
    st = _adam_state(js)
    assert adam.count == int(st.count) == 5
    for mine, ref in ((tp, jp), (adam.mu, st.mu), (adam.nu, st.nu)):
        for a, b in zip(mine, ref):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * max(np.abs(b).max(), 1e-3))


def test_make_optimizer_kinds():
    cfg = torch_config(micro_cfg())
    params = [torch.zeros(3, requires_grad=True)]
    assert type(make_optimizer(cfg, params)) is Lamb
    m = dataclasses.replace(cfg.method, optimizer="adam")
    opt = make_optimizer(dataclasses.replace(cfg, method=m), params)
    assert type(opt) is AdamW
    assert (opt.weight_decay, opt.grad_clip_norm) == (m.lambda_weight_l2,
                                                      m.grad_clip_norm)
    m = dataclasses.replace(cfg.method, optimizer="sgd")
    with pytest.raises(ValueError, match="unknown optimizer sgd"):
        make_optimizer(dataclasses.replace(cfg, method=m), params)


def _adam_cfg():
    cfg = micro_cfg()
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, optimizer="adam"))


def test_adam_train_step_follows_jax():
    cfg = _adam_cfg()
    jagent = JAgent(cfg)
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_flax_params(
        jagent.qfn, jb["rgb"] * 2 - 1, jb["pcd"], jb["low_dim_state"],
        jb["lang_goal_emb"], jb["lang_token_embs"], jagent.bounds,
        use_neural_rendering=True, nerf_target_rgb=jb["nerf_target_rgb"],
        nerf_target_pose=jb["nerf_target_pose"],
        nerf_target_intrinsic=jb["nerf_target_intrinsic"],
        action=jb["action"], seed=3)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(convert.qfunction_state_dict(params))
    assert type(tagent.optimizer()) is AdamW
    state = TrainState(jnp.zeros((), jnp.int32), params,
                       jagent.opt.init(params))
    update = jax.jit(jagent.update)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        load_jax_train_state(tagent, state)
        state, jm = update(state, jb, key)
        tm = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
        assert set(tm) == set(jm)
        for k in jm:
            j, t = float(jm[k]), float(tm[k])
            assert abs(t - j) <= 1e-4 * max(1.0, abs(j)), (i, k, t, j)
    st = _adam_state(state.opt_state)
    assert int(st.count) == tagent.optimizer().count == 2


def _tiny_agent(seed=0):
    cfg = torch_config(_adam_cfg())
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, use_neural_rendering=False))
    return TAgent(cfg, device="cpu", seed=seed)


def _steps(agent, n, seed):
    opt = agent.optimizer()
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        for p in opt.params:
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()


def test_adam_checkpoint_resumes_bit_for_bit(tmp_path):
    a = _tiny_agent()
    _steps(a, 2, seed=1)
    save_checkpoint(str(tmp_path), 1, a.qfn, optimizer=a.optimizer())
    b = _tiny_agent(seed=5)
    restore_checkpoint(str(tmp_path), b.qfn, optimizer=b.optimizer())
    oa, ob = a.optimizer(), b.optimizer()
    assert ob.count == oa.count == 2
    for x, y in zip(oa.mu + oa.nu + oa.params, ob.mu + ob.nu + ob.params):
        assert torch.equal(x, y)
    _steps(a, 1, seed=2)
    _steps(b, 1, seed=2)
    for x, y in zip(oa.params, ob.params):
        assert torch.equal(x, y)


def test_restoring_the_other_optimizer_raises(tmp_path):
    a = _tiny_agent()
    _steps(a, 1, seed=1)
    save_checkpoint(str(tmp_path / "adam"), 0, a.qfn, optimizer=a.optimizer())
    lamb = Lamb(list(a.qfn.parameters()), 1e-3)
    with pytest.raises(ValueError, match="'adam' cannot be loaded into"):
        restore_checkpoint(str(tmp_path / "adam"), a.qfn, optimizer=lamb)
    lamb.step()
    save_checkpoint(str(tmp_path / "lamb"), 0, a.qfn, optimizer=lamb)
    with pytest.raises(ValueError, match="'lamb' cannot be loaded into"):
        restore_checkpoint(str(tmp_path / "lamb"), a.qfn,
                           optimizer=a.optimizer())
    assert a.optimizer().count == 1               # nothing of LAMB's loaded


def test_replicate_state_carries_adam(tmp_path):
    run_ranks(adam_replicate_worker, 2, (str(tmp_path),), timeout=120)
    res = [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in (0, 1)]
    assert res[0]["count"] == res[1]["count"] == 3
    for key in ("mu", "nu", "params"):
        for x, y in zip(res[0][key], res[1][key]):
            assert torch.equal(x, y)
    assert res[1]["was_different"]
