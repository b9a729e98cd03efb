"""The plain reference against the port's plain path at micro widths, in
float32 on the CPU (the tests alone compare the two; the benchmark's
reference imports nothing of the port): the same initial weights, the same
three training steps from the same batches and draws, the same Q-values."""

import numpy as np
import pytest
import torch

from bench_micro import context, micro_base, small_tower

from benchmark.correct import training_numbers
from benchmark.entries import act as act_entry
from benchmark.entries import train as train_entry
from benchmark.reference.agent import ReferenceAgent
from benchmark.reference.blocks import FP8, cast


@pytest.mark.parametrize("cell", ["w_geo.train", "w_geo_sem_dyna.train",
                                  "gnfactor_bc.train"])
def test_training_steps_match_the_port(cell, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    small_tower(monkeypatch)
    ctx = context(micro_base(str(tmp_path / "copy")), cell)
    ctx.workload = dict(ctx.workload, warmup_steps=3)
    st = train_entry.setup(ctx)
    train_entry.close(ctx, st)
    ref = train_entry.follow(ctx, st)
    assert st["init_norms"] == ref["init_norms"]
    nums = training_numbers(st, ref, ref, st["names"])
    for name in ("grad_median", "grad_worst_leaf", "change", "change_worst_leaf",
                 "loss", "trans_loss", "rgb_loss", "render_gap"):
        assert nums[name] < 2e-5, (name, nums[name])


def test_q_values_match_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    ctx = context(micro_base(str(tmp_path / "copy")), "w_geo.act")
    st = act_entry.setup(ctx)
    ref = ReferenceAgent(ctx.cfg, ctx.device, ctx.seed)
    for f in range(0, len(st["obs"]), 7):
        obs = st["obs"][f]
        q = st["agent"].q_values(obs)
        r = ref.q_values({k: torch.as_tensor(v) for k, v in obs.items()})
        np.testing.assert_array_equal(q.q_trans.reshape(1, -1).numpy(),
                                      r[0].numpy())
        np.testing.assert_array_equal(q.q_rot_grip.numpy(), r[1].numpy())


def test_fp8_cast_rounds_forward_and_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = cast(x, FP8)
    assert y.dtype == torch.float32
    assert 0 < float((y - x).detach().abs().max()) <= 3 / 16
    assert len(torch.unique(y)) < 101
    y.backward(torch.full_like(x, 0.3))
    assert float(x.grad[0]) != 0.3 and abs(float(x.grad[0]) - 0.3) < 0.3 / 4
