"""The output check fails a run whose timed path is broken underneath:
a training step that leaves the state unchanged; a splat render, the next
frame's render, the NeRF's fine pass, the semantic tower's GT embedding
the flash self-attention's forward or backward, or LAMB's step gone wrong
(`faults.py`); an act whose answer is altered where it is produced. The
harness's look for a chip is skipped; the rest of a run goes as on the
card, at micro widths on the CPU, with the cells' own limits."""

import pytest

from bench_micro import context, micro_base, small_tower

from benchmark import run as R
from benchmark.faults import planted


@pytest.fixture
def base(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    small_tower(monkeypatch)
    return micro_base(str(tmp_path / "copy"))


@pytest.mark.parametrize("cell", ["w_geo.train", "w_geo_sem_dyna.train",
                                  "gnfactor_bc.train"])
def test_sound_training_run_is_correct(cell, base):
    fields, _ = R.run_cell(context(base, cell), base)
    assert fields["correct"]


@pytest.mark.parametrize("cell,fault,caught_by", [
    pytest.param("w_geo_sem_dyna.train", "next_render", "render",
                 id="next_render-render"),
    pytest.param("w_geo_sem_dyna.train", "gt_embed", "gt_embed",
                 id="gt_embed-gt_embed"),
    pytest.param("gnfactor_bc.train", "nerf_render", "nerf_rays",
                 id="gnfactor_bc-nerf_render-nerf_rays"),
    pytest.param("gnfactor_bc.train", "gt_embed", "gt_embed",
                 id="gnfactor_bc-gt_embed-gt_embed")])
def test_render_or_embedding_gone_wrong(cell, fault, caught_by, base):
    with planted(fault):
        fields, checks = R.run_cell(context(base, cell), base)
    assert not fields["correct"]
    numbers = {n: v for n, v, _ in checks}
    limits = {n: lim for n, _, lim in checks}
    assert numbers[caught_by] > limits[caught_by], numbers


def test_flash_forward_that_skips_a_key_tile(base):
    """With 512 latents (four 128-key tiles; the micro copy's 32 fill
    none), the flash forward that skips its second tile's P·V fails
    `attn`, and the sound run passes it."""
    import json

    from benchmark import harness
    p = harness.path("configs", "gnfactor_bc", base=base)
    with open(p) as f:
        cfg = json.load(f)
    cfg["config"]["method"]["num_latents"] = 512
    with open(p, "w") as f:
        json.dump(cfg, f)
    fields, checks = R.run_cell(context(base, "gnfactor_bc.train"), base)
    assert fields["correct"], checks
    with planted("flash_forward"):
        fields, checks = R.run_cell(context(base, "gnfactor_bc.train"), base)
    assert not fields["correct"]
    attn = [(v, lim) for n, v, lim in checks if n == "attn"][0]
    assert attn[0] > attn[1], checks


def test_flash_backward_that_skips_a_query_tile(base):
    """The flash backward that leaves dq at zero (every query of the micro
    copy's 32) fails `attn_bwd`, and nothing before the backward."""
    with planted("flash_backward"):
        fields, checks = R.run_cell(context(base, "gnfactor_bc.train"), base)
    assert not fields["correct"]
    failed = {n for n, v, lim in checks if not v <= lim}
    assert failed == {"attn_bwd"}, checks


def test_lamb_step_without_its_trust_ratio(base):
    """LAMB's update with the trust ratio taken as 1 fails `lamb_step`."""
    with planted("lamb_trust"):
        fields, checks = R.run_cell(context(base, "gnfactor_bc.train"), base)
    assert not fields["correct"]
    lamb = [(v, lim) for n, v, lim in checks if n == "lamb_step"][0]
    assert lamb[0] > lamb[1], checks


def test_step_that_leaves_its_state_unchanged(base):
    ctx = context(base, "w_geo.train")

    def unchanged(agent, batch, gen):
        opt = agent.optimizer()
        step = opt.step
        opt.step = lambda: None
        try:
            return agent.update(batch, gen)
        finally:
            opt.step = step

    ctx.step = unchanged
    fields, checks = R.run_cell(ctx, base)
    assert not fields["correct"]
    assert dict((n, v) for n, v, _ in checks)["change"] == pytest.approx(1.0, abs=0.05)


def test_sound_act_run_is_correct(base):
    fields, _ = R.run_cell(context(base, "w_geo.act"), base)
    assert fields["correct"]


def test_act_with_an_altered_answer(base):
    ctx = context(base, "w_geo.act")

    def altered(agent, obs):
        res = agent.act(obs)
        v = agent.cfg.method.voxel_sizes[0]
        q = agent.q_values(obs).q_trans.reshape(-1)
        worst = int(q.argmin())
        res.trans_coords[0] = res.trans_coords.new_tensor(
            [worst // (v * v), (worst // v) % v, worst % v])
        return res

    ctx.act = altered
    fields, _ = R.run_cell(ctx, base)
    assert not fields["correct"]
