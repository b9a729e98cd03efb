"""The plain reference's NeRF (`reference/nerf_renderer.py`) against the
port's at micro width in float32 on the CPU: the same seeded weights, the
same draws from one generator seed, the losses and every leaf's gradient;
the GNFACTOR_BC reference agent draws the program's weights; the w_geo
reference builds the same leaves, in the same order, as before the NeRF
branch came in."""

import hashlib
import json

import pytest
import torch

from bench_micro import MICRO, _merge

from benchmark import harness
from benchmark.reference import qfunction as RQ
from benchmark.reference.agent import ReferenceAgent
from benchmark.reference.blocks import initialize as ref_initialize


def _trees(name="gnfactor_bc"):
    tree = harness.load_json("configs", name)["config"]
    _merge(tree, json.loads(json.dumps(MICRO)))
    tree["replay"]["path"] = None
    from manigaussian_tpu_torch.utils.config_io import from_dict
    return from_dict(tree), harness.namespace(tree)


def _camera(w: int):
    """A camera 1 m above the workspace looking down its z axis, so that
    every ray crosses the voxel box."""
    c2w = torch.eye(4)
    c2w[:3, :3] = torch.diag(torch.tensor([1.0, -1.0, -1.0]))
    c2w[:3, 3] = torch.tensor([0.2, 0.0, 2.6])
    k = torch.tensor([[float(w), 0.0, w / 2], [0.0, float(w), w / 2],
                      [0.0, 0.0, 1.0]])
    return c2w[None], k[None]


def _render(renderer, seed: int):
    torch.manual_seed(seed)
    r = renderer
    w, v = r.image_width, 20
    volume = torch.randn(1, v, v, v, r.nerf.mlp.d_latent, requires_grad=True)
    gt_rgb = torch.rand(1, w, w, 3)
    gt_embed = torch.randn(1, w, w, r.d_embed)
    pose, k = _camera(w)
    losses = r(volume, gt_rgb, pose, k, gt_embed,
               torch.Generator().manual_seed(seed + 1), training=True)
    losses.loss.backward()
    grads = {n: p.grad for n, p in r.named_parameters()}
    grads["volume"] = volume.grad
    return losses, grads


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_reference_nerf_matches_the_port(seed):
    from manigaussian_tpu_torch.agents.qfunction import \
        renderer_from_config as port_renderer
    from manigaussian_tpu_torch.models.blocks import \
        initialize as port_initialize
    cfg_port, cfg = _trees()
    port = port_initialize(port_renderer(cfg_port.method),
                           torch.Generator().manual_seed(seed))
    ref = ref_initialize(RQ.renderer_from_config(cfg.method),
                         torch.Generator().manual_seed(seed))
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    for p, q in zip(port.parameters(), ref.parameters()):
        assert torch.equal(p, q)
    lp, gp = _render(port, seed)
    lr, gr = _render(ref, seed)
    # the forward is the same float32 operations in the same order: equal
    for name, a, b in zip(lp._fields, lp, lr):
        assert torch.equal(a, b), name
    # the backward too: on the CPU both sum a voxel's cotangents in the
    # order of the points (the port's stable sort and `segment_sum`, the
    # reference's in-turn `index_add`), so every leaf's gradient and the
    # volume's are equal
    for name in gp:
        assert torch.equal(gp[name], gr[name]), name
    assert float(gp["volume"].abs().max()) > 0


def test_gnfactor_reference_draws_the_programs_weights():
    from manigaussian_tpu_torch.agents.registry import create_agent
    cfg_port, cfg = _trees()
    seed = 2 ** 33 + 5
    agent = create_agent(cfg_port, device="cpu", seed=seed)
    ref = ReferenceAgent(cfg, torch.device("cpu"), seed)
    prog = list(agent.qfn.named_parameters())
    mine = list(ref.qfn.named_parameters())
    assert [n for n, _ in prog] == [n for n, _ in mine]
    assert any(n.startswith("neural_renderer.nerf.mlp.") for n, _ in prog)
    for (n, p), (_, q) in zip(prog, mine):
        assert torch.equal(p, q), n


def test_w_geo_reference_leaves_unchanged():
    """The act cell's reference: the names and shapes of every leaf at the
    published width, in order, as the reference built them before the NeRF
    branch (180 leaves; the digest of their `name:shape` lines)."""
    cfg = harness.namespace(harness.load_json("configs", "w_geo")["config"])
    with torch.device("meta"):
        q = RQ.QFunction(cfg.method)
    rows = [f"{n}:{tuple(p.shape)}" for n, p in q.named_parameters()]
    assert len(rows) == 180
    assert hashlib.sha256("\n".join(rows).encode()).hexdigest() == (
        "6df76fa39fc9797da3437b3c348b38b32c843ce319b55244ab1adc27f82476b4")
