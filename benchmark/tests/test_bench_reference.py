"""The plain reference against the port's plain path at micro widths, in
float32 on the CPU (the tests alone compare the two; the benchmark's
reference imports nothing of the port): the same initial weights, the same
three training steps from the same batches and draws, the same Q-values;
the port's flash backward as near the float64 gradient as float32
rounds."""

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
    side = train_entry.backward_checked(ctx, st)
    nums = training_numbers(side, ref, ref, st["names"])
    for name in ("grad_median", "grad_worst_leaf", "change", "change_worst_leaf",
                 "loss", "trans_loss", "rgb_loss", "render_gap", "attn_gap",
                 "attn_bwd"):
        assert nums[name] < 2e-5, (name, nums[name])
    # the program's first LAMB update against the reference's in float64:
    # the rounding of p0 + Δp in float32
    assert nums["lamb_step"] < 1e-3, nums["lamb_step"]
    if cell == "gnfactor_bc.train":
        assert nums["nerf_rays_gap"] < 2e-5, nums["nerf_rays_gap"]


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


def test_gt_embed_at_full_width_matches_after_alignment(monkeypatch):
    """At GNFactor's 512 channels the PCA keeps every channel of the tower:
    the reference's GT embedding is the program's up to a rotation of the
    channels (the randomized PCA's basis of a flat spectrum is not fixed by
    the features), which `aligned_gap` takes out."""
    from manigaussian_tpu_torch.models import foundation as PF

    from benchmark.correct import aligned_gap
    from benchmark.reference import foundation as RF
    small_tower(monkeypatch)
    rgb = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    prog = PF.extract_gt_embed(rgb, PF.SDVaeFeatureExtractor(None, device="cpu"),
                              512)
    ref = RF.gt_embed(RF.sd_vae_tower(torch.device("cpu")), rgb, 512)
    assert prog.shape == ref.shape == (1, 32, 32, 512)
    assert aligned_gap(torch, prog.double(), ref.double()) < 1e-4
