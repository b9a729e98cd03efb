"""The multi-tensor LAMB kernel (`csrc/lamb.cu` through `utils/optimizers.
Lamb.step`) against its plain version (`ops/fused_lamb.lamb_step_reference`,
the loop that CPU leaves take), both on the card.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_lamb_gpu.py -m gpu

Three consecutive steps from the same gradients, on leaves of every kind up
to `gnfactor_bc`'s 178 at its published width: the moments m and v equal
the loop's bit for bit (the kernel rounds each op on its own, in the loop's
order and with its float32 constants). p may differ through the trust
ratio alone, whose two norms the kernel sums in another order than
`torch.linalg.norm` (float32 sums of up to 10⁶ squares: a few units of 1e-7
of the ratio, 1e-5 of a step's change is far above that), plus one rounding
of p + Δ a step (an ulp of p each): |p_kernel − p_loop| ≤ 1e-5 · Σ|Δp| +
4 ulp(p). The kernel is bitwise repeatable (no atomics), so a state dict
round trip gives the next step bit for bit, and one training update
launches its two kernels under `update/optimizer` and nothing else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch import config as C
from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
from manigaussian_tpu_torch.agents.qfunction import QFunction
from manigaussian_tpu_torch.ops.fused_lamb import (CHUNK, FusedLamb,
                                                   lamb_step_reference)
from manigaussian_tpu_torch.utils.config_io import load_config
from manigaussian_tpu_torch.utils.optimizers import Lamb

pytestmark = pytest.mark.gpu

LR, B1, B2, EPS = 5e-4, 0.9, 0.999, 1e-6   # GNFACTOR_BC.yaml's lr; LAMB's defaults
STEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    return torch.device("cuda")


def gnf_micro_cfg():
    cfg = C.micro_variant("w_geo")
    # the cells' LAMB clips no gradient: grad_clip_norm 0 as GNFACTOR_BC's
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, name="GNFACTOR_BC", grad_clip_norm=0.0))


def gnf_micro_shapes():
    with torch.device("meta"):
        return [tuple(p.shape) for p in QFunction(gnf_micro_cfg().method)
                .parameters()]


def gnf_full_shapes():
    """The leaves of `gnfactor_bc` at its published width, as the train
    entry point builds it from `--variant w_geo`, conf/method/GNFACTOR_BC.yaml
    and `method.neural_renderer.d_embed=512`: 178 leaves, 40,064,145
    elements."""
    cfg = load_config(None, ["method.name=GNFACTOR_BC",
                             "method.neural_renderer.renderer_type=nerf",
                             "method.neural_renderer.foundation_model_name="
                             "diffusion",
                             "method.neural_renderer.d_embed=512"],
                      variant="w_geo")
    with torch.device("meta"):
        return [tuple(p.shape) for p in QFunction(cfg.method).parameters()]


# each case: the leaves' shapes, how p is drawn, and which leaf has no
# gradient (None: every leaf has one)
def case_leaves(case, rng):
    if case == "gnfactor_bc_micro":
        shapes = gnf_micro_shapes()
        return [0.05 * rng.standard_normal(s) for s in shapes], None
    if case == "gnfactor_bc":
        shapes = gnf_full_shapes()
        assert len(shapes) == 178
        assert sum(int(np.prod(s)) for s in shapes) == 40_064_145
        return [0.05 * rng.standard_normal(s) for s in shapes], None
    if case == "one_element":
        return [rng.standard_normal(1)], None
    if case == "many_chunks":
        return [0.02 * rng.standard_normal(37 * CHUNK + 11)], None
    if case == "zero_leaf":        # trust ratio 1 on the first step
        return [np.zeros((512, 512)), np.zeros(512)], None
    if case == "clamped":          # ‖p‖ over 10: clamped to 10
        return [0.5 + 0.1 * rng.standard_normal((300, 300))], None
    if case == "no_gradient":      # read as zeros
        return [0.1 * rng.standard_normal((64, 64)),
                0.1 * rng.standard_normal(4099)], 1
    raise ValueError(case)


CASES = ["gnfactor_bc_micro", "one_element", "many_chunks", "zero_leaf",
         "clamped", "no_gradient", "gnfactor_bc"]


def on(device, arrays):
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-6])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_the_loop_over_three_steps(cuda, case, weight_decay):
    rng = np.random.default_rng(CASES.index(case))
    values, missing = case_leaves(case, rng)
    opt = Lamb(on(cuda, values), LR, B1, B2, EPS, weight_decay=weight_decay)
    params, mu, nu = on(cuda, values), on(cuda, [0 * v for v in values]), \
        on(cuda, [0 * v for v in values])
    launches = FusedLamb.launches
    moved = [torch.zeros_like(p, dtype=torch.float64) for p in params]
    for _ in range(STEPS):
        grads = on(cuda, [(1e-2 * rng.standard_normal(v.shape)
                           if i != missing else np.zeros(v.shape))
                          for i, v in enumerate(values)])
        for i, (p, g) in enumerate(zip(opt.params, grads)):
            p.grad = None if i == missing else g.clone()
        opt.step()
        before = [p.clone() for p in params]
        lamb_step_reference(params, grads, mu, nu, LR, B1, B2, EPS,
                            weight_decay)
        for acc, p, q in zip(moved, params, before):
            acc += (p.double() - q.double()).abs()
        for i, (a, b) in enumerate(zip(opt.mu + opt.nu, mu + nu)):
            assert torch.equal(a, b), (case, i)
        for i, (a, b, acc) in enumerate(zip(opt.params, params, moved)):
            ulp = torch.from_numpy(np.spacing(np.abs(
                b.cpu().numpy()))).to(cuda).double()
            gap = (a.double() - b.double()).abs()
            assert bool((gap <= 1e-5 * acc + 4 * ulp).all()), (
                case, i, float((gap - 1e-5 * acc - 4 * ulp).max()))
    assert FusedLamb.launches - launches == 2 * STEPS
    assert all(bool(torch.isfinite(p).all()) for p in opt.params)


def test_kernel_takes_gradients_at_any_offset(cuda):
    """Gradients as views of one flat buffer at offsets that are no multiple
    of 4 elements, as `parallel.train_sharded.average_gradients` leaves them
    (the kernel's scalar path): the same update, bit for bit, as from
    separate tensors (16-byte loads)."""
    rng = np.random.default_rng(7)
    values, _ = case_leaves("gnfactor_bc_micro", rng)
    values += [0.1 * rng.standard_normal(3 * CHUNK + 5)]
    grads = [1e-2 * rng.standard_normal(v.shape) for v in values]
    flat = torch.zeros(1 + sum(g.size + 1 for g in grads), device=cuda)
    views, at = [], 1
    for g in grads:
        view = flat[at:at + g.size].view(g.shape)
        view.copy_(torch.tensor(g, dtype=torch.float32))
        views.append(view)
        at += g.size + 1
    assert any(v.data_ptr() % 16 for v in views)
    runs = []
    for leaf_grads in (views, on(cuda, grads)):
        opt = Lamb(on(cuda, values), LR, weight_decay=1e-6)
        for _ in range(2):
            for p, g in zip(opt.params, leaf_grads):
                p.grad = g
            opt.step()
        runs.append(opt.params + opt.mu + opt.nu)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_kernel_is_bitwise_repeatable(cuda):
    rng = np.random.default_rng(1)
    values, _ = case_leaves("gnfactor_bc_micro", rng)
    grads = [1e-2 * rng.standard_normal(v.shape) for v in values]
    runs = []
    for _ in range(2):
        opt = Lamb(on(cuda, values), LR, weight_decay=1e-6)
        for _ in range(2):
            for p, g in zip(opt.params, on(cuda, grads)):
                p.grad = g
            opt.step()
        runs.append(opt.params + opt.mu + opt.nu)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_state_dict_round_trip_gives_the_same_next_step(cuda):
    rng = np.random.default_rng(2)
    values, _ = case_leaves("gnfactor_bc_micro", rng)
    grads = [on(cuda, [1e-2 * rng.standard_normal(v.shape) for v in values])
             for _ in range(2)]
    opt = Lamb(on(cuda, values), LR, weight_decay=1e-6)
    for p, g in zip(opt.params, grads[0]):
        p.grad = g
    opt.step()
    state = opt.state_dict()
    resumed = Lamb([p.detach().clone() for p in opt.params], LR,
                   weight_decay=1e-6)
    resumed.load_state_dict(state)
    for o in (opt, resumed):
        for p, g in zip(o.params, grads[1]):
            p.grad = g.clone()
        o.step()
    assert resumed.count == opt.count == 2
    for a, b in zip(opt.params + opt.mu + opt.nu,
                    resumed.params + resumed.mu + resumed.nu):
        assert torch.equal(a, b)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    ok = lambda *s: torch.zeros(*s, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):     # a CPU/CUDA mix
        FusedLamb([ok(3), torch.zeros(3)], [ok(3), ok(3)], [ok(3), ok(3)])
    with pytest.raises(ValueError, match="float32"):
        FusedLamb([ok(3).double()], [ok(3).double()], [ok(3).double()])
    with pytest.raises(ValueError, match="non-contiguous"):
        FusedLamb([ok(4, 3).t()], [ok(3, 4)], [ok(3, 4)])
    fused = FusedLamb([ok(3)], [ok(3)], [ok(3)])
    for g in (torch.zeros(3), ok(3).double(), ok(6)[::2]):
        with pytest.raises(ValueError):
            fused.step([g], LR, B1, B2, EPS, 0.0)


def make_batch(seed):
    """One row of the training batch's schema at the micro size (as
    tests/test_torch_spans.make_batch, which this file does not import: a
    `tests` package installed elsewhere can shadow this directory)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    return {
        "rgb": rng.uniform(size=(1, 1, 32, 32, 3)).astype(f),
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((1, 1, 32, 32, 3))).astype(f),
        "low_dim_state": np.zeros((1, 4), f),
        "lang_goal_emb": (0.1 * rng.standard_normal((1, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((1, 77, 512))).astype(f),
        "trans_action_indicies": np.array([[10, 9, 11]], np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]], np.int32),
        "ignore_collisions": np.ones((1, 1), np.int32),
        "gripper_pose": np.array([[0.2, 0, 1.1, 0, 0, 0, 1.0]], f),
        "nerf_target_rgb": rng.uniform(size=(1, 32, 32, 3)).astype(f),
        "nerf_target_pose": np.eye(4, dtype=f)[None],
        "nerf_target_intrinsic": intr[None],
    }


def kernels_under(event):
    """Device work launched inside a profiler range, its children's too."""
    return len(event.kernels) + sum(kernels_under(c) for c in event.cpu_children)


def test_one_update_launches_at_most_three_kernels_under_the_optimizer(cuda):
    from torch.profiler import ProfilerActivity, profile
    agent = ManiGaussianBCAgent(gnf_micro_cfg(), device=cuda, seed=3)
    gen = torch.Generator().manual_seed(5)
    agent.update(make_batch(0), gen)      # builds the tables and the library
    launches = FusedLamb.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        agent.update(make_batch(1), gen)
        torch.cuda.synchronize()
    assert FusedLamb.launches - launches == 2
    ranges = [e for e in prof.events() if e.name == "update/optimizer"]
    assert len(ranges) == 1
    assert 1 <= kernels_under(ranges[0]) <= 3, [
        k.name for k in ranges[0].kernels]
