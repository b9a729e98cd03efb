"""`flops.py` against hand counts at the published widths and against
torch's flop counter on real tensors at micro widths."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_micro import MICRO, _merge

from benchmark import flops, harness
from benchmark.reference.qfunction import perceiver_from_config


def _cfg(name="w_geo", micro=False):
    tree = harness.load_json("configs", name)["config"]
    if micro:
        _merge(tree, json.loads(json.dumps(MICRO)))
    return harness.namespace(tree)


def test_published_counts_hold_the_100_cubed_convs():
    cfg = _cfg()
    # final 256→128 and up0's post-resize 128→128, 3³ at 100³ voxels
    convs = 2 * 100 ** 3 * 27 * (256 * 128 + 128 * 128)
    fwd = flops.model_flops(cfg, training=False)
    assert convs < fwd < 1.3 * convs
    train = flops.model_flops(cfg, training=True)
    assert 2.5 * fwd < train < 3.5 * fwd


def test_flash_bound_by_hand():
    m = _cfg().method
    act = flops.flash_bound_s(m, training=False)["fwd"]
    assert act == pytest.approx(4 * 8 * 2048 ** 2 * 64 / 989e12)
    train = flops.flash_bound_s(m, training=True)
    # the dropout mask's 7 integer operations a score bound the forward
    assert train["fwd"] == pytest.approx(7 * 8 * 2048 ** 2 / (132 * 64 * 1.98e9))
    assert train["bwd"] == pytest.approx(10 * 8 * 2048 ** 2 * 64 / 989e12)


def test_meta_count_equals_real_tensors_at_micro_width():
    cfg = _cfg(micro=True)
    m = cfg.method
    torch.manual_seed(0)
    policy = perceiver_from_config(m)
    for p in policy.parameters():
        torch.nn.init.normal_(p, std=0.02)
    v = m.voxel_sizes[0]
    counter = FlopCounterMode(display=False)
    with counter:
        out = policy(torch.randn(1, v, v, v, 10), torch.randn(1, 4),
                     torch.randn(1, m.language_model_dim * 2),
                     torch.randn(1, 77, m.language_model_dim))
    assert counter.get_total_flops() == flops.model_flops(cfg, training=False)
    assert out[0].shape == (1, v, v, v, 1)


def test_nerf_count_by_hand():
    """GNFactor's step counts the NeRF's ResnetFC over 512 rays × (64
    coarse + 96 fine) points, forward, dX and dW (3 × the forward), in
    place of the Gaussian regressor: lin_in 42→512, three lin_z 128→512,
    five blocks of two 512→512, lin_out 512→7."""
    cfg = _cfg("gnfactor_bc")
    r = cfg.method.neural_renderer
    points = r.ray_chunk_size * (2 * r.n_coarse + r.n_fine)
    assert points == 81920 == flops.nerf_points(r)
    d = r.mlp.d_hidden
    per_point = 2 * (42 * d + 3 * r.d_latent * d + 2 * r.mlp.n_blocks * d * d
                     + d * (4 + r.d_embed))
    no_render = harness.namespace(json.loads(json.dumps(
        harness.load_json("configs", "gnfactor_bc")["config"])))
    no_render.method.use_neural_rendering = False
    assert flops.model_flops(cfg, training=True) - flops.model_flops(
        no_render, training=True) == 3 * points * per_point
    # the act renders nothing
    assert flops.model_flops(cfg, training=False) == flops.model_flops(
        _cfg(), training=False)


@pytest.mark.parametrize("name,training,count", [
    ("w_geo", False, 2910686014464), ("w_geo", True, 9006532970496),
    ("w_geo_sem_dyna", True, 9287584892928)])
def test_splat_counts_unchanged(name, training, count):
    """The splat tiers' counts as before the NeRF was counted (`mfu.act`
    in `w_geo.act` reads the same FLOPs)."""
    assert flops.model_flops(_cfg(name), training=training) == count
