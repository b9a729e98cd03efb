"""The port's named profiler ranges on the act path and in the training
step, on the CPU at the micro `w_geo` configuration: `act` runs as six
top-level `policy/` stages in order, on the calling thread, holding every
ATen op, as function-scope records (no annotation on the device's
timeline); `update/forward` holds the four shared stages; with no profiler
running no range is entered; the ranges change no result; and each range
is small enough for the benchmark's trace reduction (`benchmark/trace.py`
looks back at most 400 host events for the innermost range open at a
device idle gap) to place every gap inside it.

The act is also free of host-device synchronisation after its inputs: no
op that on CUDA copies from pageable host memory or reads a device value
back (`torch.tensor` of a host scalar, `bincount`, `.item()`, `nonzero`)
runs between `policy/inputs` and the result, counted here in the CPU
profile and, on the card (marked `gpu`), under CUDA's sync debug mode. The
configuration's constants come from `utils.device.constant`, made once,
and give the bits that a tensor made on every call gives.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from manigaussian_tpu_torch import config as C
from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
from manigaussian_tpu_torch.ops import voxelize as voxelize_module
from manigaussian_tpu_torch.utils import device as device_module
from manigaussian_tpu_torch.utils import profiling

ACT_STAGES = ("policy/inputs", "policy/voxelize", "policy/encoder",
              "policy/perceiver", "policy/decoder", "policy/decode")
SHARED_STAGES = ACT_STAGES[1:5]
# benchmark/trace.py: how far back it looks for the range open at a gap
TRACE_LOOKBACK = 400
CALL = "test/call"
# ATen ops that synchronise the host with a CUDA stream: `torch.tensor` of
# a host value (a pageable copy), and reads of a device value by the host
SYNCING_OPS = ("aten::lift_fresh", "aten::bincount",
               "aten::_local_scalar_dense", "aten::item", "aten::nonzero")


def micro_cfg(policy_dtype="float32"):
    cfg = C.micro_variant("w_geo", camera_resolution=(16, 16))
    return dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, policy_dtype=policy_dtype))


def make_batch(seed=0, b=1, h=16, w=16, img=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    return {
        "rgb": rng.uniform(size=(b, 1, h, w, 3)).astype(f),
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((b, 1, h, w, 3))).astype(f),
        "low_dim_state": np.zeros((b, 4), f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": np.array([[10, 9, 11]] * b, np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]] * b, np.int32),
        "ignore_collisions": np.ones((b, 1), np.int32),
        "gripper_pose": np.tile(np.array([0.2, 0, 1.1, 0, 0, 0, 1.0], f),
                                (b, 1)),
        "nerf_target_rgb": rng.uniform(size=(b, img, img, 3)).astype(f),
        "nerf_target_pose": np.tile(np.eye(4, dtype=f), (b, 1, 1)),
        "nerf_target_intrinsic": np.tile(intr, (b, 1, 1)),
    }


OBS_KEYS = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")


@pytest.fixture(scope="module")
def agent():
    torch.manual_seed(0)
    return ManiGaussianBCAgent(micro_cfg(), device="cpu", seed=3)


@pytest.fixture(scope="module")
def obs():
    return {k: v for k, v in make_batch().items() if k in OBS_KEYS}


def profiled(fn):
    """fn() under a CPU profiler inside the range CALL; returns the
    events, sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            fn()
    return sorted(prof.events(), key=lambda e: e.time_range.start)


def within(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_act_runs_as_six_stages_holding_every_op(agent, obs):
    agent.act(obs)
    events = profiled(lambda: agent.act(obs))
    call = next(e for e in events if e.name == CALL)
    stages = [e for e in events
              if e.name.startswith("policy/") and e.name.count("/") == 1]
    assert tuple(e.name for e in stages) == ACT_STAGES
    assert all(e.thread == call.thread and within(e, call) for e in stages)
    # function scope: no user annotation, so nothing on the device timeline
    assert {e.scope for e in events if e.name.startswith("policy/")} == {
        int(torch._C._profiler.RecordScope.FUNCTION)}
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    outside = [e.name for e in ops if not any(within(e, s) for s in stages)]
    assert outside == []


def test_no_range_is_entered_without_a_profiler(agent, obs, monkeypatch):
    entered = []
    real = profiling._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", counting)
    agent.act(obs)
    assert entered == []
    profiled(lambda: agent.act(obs))
    assert set(ACT_STAGES) <= set(entered)


def test_act_is_the_same_with_the_profiler_on(agent, obs):
    off = agent.act(obs)
    on = []
    profiled(lambda: on.append(agent.act(obs)))
    for name, a, b in zip(off._fields, off, on[0]):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_update_forward_holds_the_shared_stages():
    agent = ManiGaussianBCAgent(micro_cfg(), device="cpu", seed=3)
    batch = make_batch()
    gen = torch.Generator().manual_seed(5)
    events = profiled(lambda: agent.update(batch, gen))
    forward = [e for e in events if e.name == "update/forward"]
    assert len(forward) == 1
    for name in SHARED_STAGES:
        spans = [e for e in events if e.name == name]
        assert len(spans) == 1, name
        assert spans[0].thread == forward[0].thread
        assert within(spans[0], forward[0]), name
    assert not any(e.name in ("policy/inputs", "policy/decode")
                   for e in events)


@pytest.mark.parametrize("policy_dtype", ["float32", "bfloat16"])
def test_every_op_is_near_its_innermost_range(policy_dtype, obs):
    """Counted as the trace reduction counts: the host events that started
    since the innermost `policy/` range around an event began stay under
    its lookback, so a gap anywhere in the act finds its range."""
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device="cpu",
                                seed=3)
    agent.act(obs)
    events = profiled(lambda: agent.act(obs))
    host = [e for e in events
            if e.name != CALL and not e.name.startswith("cuda")]
    index = {id(e): i for i, e in enumerate(host)}
    ranges = [e for e in host if e.name.startswith("policy/")]
    worst = {}
    for e in host:
        if e.name.startswith("policy/"):
            continue
        around = [r for r in ranges if r is not e and within(e, r)]
        if not around:
            continue
        inner = max(around, key=lambda r: r.time_range.start)
        back = index[id(e)] - index[id(inner)]
        worst[inner.name] = max(worst.get(inner.name, 0), back)
    assert {"/".join(n.split("/")[:2]) for n in worst} == set(ACT_STAGES)
    assert max(worst.values()) < TRACE_LOOKBACK * 0.9, worst


@pytest.mark.parametrize("policy_dtype", ["float32", "bfloat16"])
def test_act_does_not_sync_after_its_inputs(policy_dtype, obs):
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device="cpu",
                                seed=3)
    agent.act(obs)
    events = profiled(lambda: agent.act(obs))
    inputs = [e for e in events if e.name == "policy/inputs"]
    assert len(inputs) == 1
    syncing = [e.name for e in events if e.name in SYNCING_OPS
               and not within(e, inputs[0])]
    assert syncing == []


@pytest.mark.gpu
@pytest.mark.parametrize("policy_dtype", ["float32", "bfloat16"])
def test_act_does_not_sync_on_cuda(policy_dtype, obs):
    """The observation already on the card, so that `policy/inputs` copies
    nothing: any synchronising call of the act then raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    cfg = micro_cfg(policy_dtype)
    # the bf16 flash kernel's least head dim
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, latent_dim_head=16))
    agent = ManiGaussianBCAgent(cfg, device="cuda", seed=3)
    on_card = {k: torch.as_tensor(v, device="cuda") for k, v in obs.items()}
    first = agent.act(on_card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = agent.act(on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name, a, b in zip(first._fields, first, again):
        assert torch.equal(a, b), name


def test_constant_is_made_once_per_value_dtype_and_device():
    c = device_module.constant
    a = c(0.125, torch.float32, "cpu")
    assert a.shape == () and a.dtype == torch.float32 and float(a) == 0.125
    assert c(0.125, torch.float32, torch.device("cpu")) is a
    assert c(0.125, torch.bfloat16, "cpu") is not a
    assert c(0.125, torch.bfloat16, "cpu").dtype == torch.bfloat16
    assert c(0.25, torch.float32, "cpu") is not a
    # equal under ==, other bits or another type
    assert torch.signbit(c(-0.0, torch.float32, "cpu"))
    assert not torch.signbit(c(0.0, torch.float32, "cpu"))
    assert c(2, torch.int64, "cpu") is not c(2.0, torch.int64, "cpu")
    v = c((0.0, 0.0, 1.0), torch.float32, "cpu")
    assert v.tolist() == [0.0, 0.0, 1.0] and c((0.0, 0.0, 1.0),
                                               torch.float32, "cpu") is v
    with torch.inference_mode():
        made_inside = c(0.375, torch.float32, "cpu")
    assert not made_inside.is_inference()


def _segment_sum_by_bincount(rows, index, n):
    order = torch.argsort(index, stable=True)
    return torch.segment_reduce(rows[order], "sum",
                                lengths=torch.bincount(index, minlength=n),
                                axis=0, unsafe=True)


@pytest.mark.parametrize("policy_dtype", ["float32", "bfloat16"])
def test_act_is_bitwise_the_per_call_formula(policy_dtype, obs, monkeypatch):
    """Against the act with every constant made anew on each call and the
    voxelizer's counts from `bincount`, from the same seed."""
    agent = ManiGaussianBCAgent(micro_cfg(policy_dtype), device="cpu",
                                seed=3)
    hoisted = agent.act(obs)
    fresh = lambda value, dtype, device: torch.tensor(value, dtype=dtype,
                                                      device=device)
    users = [m for name, m in sys.modules.items()
             if name.startswith("manigaussian_tpu_torch.")
             and getattr(m, "constant", None) is device_module.constant]
    assert len(users) >= 5
    for m in users:
        monkeypatch.setattr(m, "constant", fresh)
    monkeypatch.setattr(voxelize_module, "segment_sum",
                        _segment_sum_by_bincount)
    per_call = agent.act(obs)
    for name, a, b in zip(hoisted._fields, hoisted, per_call):
        assert a.dtype == b.dtype and torch.equal(a, b), name
