"""The CUDA tile-blend kernels against their plain PyTorch version, on the
card.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_blend_gpu.py -m gpu

Tolerances: the JAX golden tests' rules (`assert_mostly_close`): outputs
atol 1e-4 / rtol 1e-3 with at most 0.5 % of elements outside, gradients
atol 2e-4 / rtol 1e-3 with at most 2 % outside. The kernels walk each
segment of a pixel's splats one by one from the product of the earlier
segments, the plain version in chunked prefix sums, so a pixel whose
transmittance sits on the T < 1e-4 latch may flip. Both kernels are bitwise
repeatable (no atomics).

Real frames: random Gaussians binned and packed by the port's rasterizer on
the card (the training frame, a batch of two, the micro config's capacity,
empty tiles, 65,536 Gaussians, the bench twin's frame), one rank's window of
the tile-sharded renderer, and the JAX package's pinned frames
(tests/goldens/*.npz) through the kernel route.
"""

import os

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch import bench
from manigaussian_tpu_torch.ops import gaussian_math as gm
from manigaussian_tpu_torch.ops.blend import (blend_backward, blend_forward,
                                              blend_tiles,
                                              blend_tiles_reference)
from manigaussian_tpu_torch.ops.camera import novel_camera_calib
from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                   pack_tiles, rasterize,
                                                   tile_lists)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _cuda_case(seed, t, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    counts, origins, attrs, livet, grads = random_tiles(seed, t=t, k=k)
    args = [torch.from_numpy(x).cuda() for x in (counts, origins, attrs, livet)]
    return args, [torch.from_numpy(x).cuda() for x in grads]


def random_tiles(seed, t=8, k=128, n_feat=3, tile=16):
    """Random splat lists over t tiles of a 2-tile-wide image."""
    rng = np.random.default_rng(seed)
    origins = np.stack([(np.arange(t) % 2) * tile,
                        (np.arange(t) // 2) * tile], -1).astype(np.float32)
    counts = rng.integers(0, k + 1, size=(t, 1)).astype(np.int32)
    counts[0, 0] = k                                  # one full list
    c = 9 + n_feat
    attrs = np.zeros((t, c, k), np.float32)
    attrs[:, 0:2] = origins[:, :, None] + rng.uniform(-4, tile + 4, (t, 2, k))
    sx, sy = rng.uniform(1.0, 6.0, (2, t, k))
    rho = rng.uniform(-0.6, 0.6, (t, k))
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    attrs[:, 2] = sy ** 2 / det                       # conic of the 2D cov
    attrs[:, 3] = -rho * sx * sy / det
    attrs[:, 4] = sx ** 2 / det
    attrs[:, 5] = rng.uniform(0.05, 0.95, (t, k))  # as tests/helpers.random_scene
    attrs[:, 6:] = rng.standard_normal((t, 3 + n_feat, k))
    livet = (np.arange(k)[None, None, :] < counts[:, :, None]).astype(np.float32)
    grads = [rng.standard_normal((t, 3, tile * tile)).astype(np.float32),
             rng.standard_normal((t, n_feat, tile * tile)).astype(np.float32),
             rng.standard_normal((t, 1, tile * tile)).astype(np.float32)]
    return counts, origins, attrs, livet, grads



def _mostly_close(a, b, atol, rtol, max_frac):
    bad = ~np.isclose(a, b, atol=atol, rtol=rtol)
    assert bad.mean() <= max_frac, (bad.mean(), np.abs(a - b).max())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,t,k,chunk", [(0, 8, 128, 32), (1, 64, 2048, 256),
                                            (2, 64, 512, 32), (3, 16, 256, 128),
                                            (5, 128, 2048, 256), (6, 8, 704, 4)])
def test_cuda_blend_matches_plain_version(seed, t, k, chunk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    counts, origins, attrs, livet, grads = random_tiles(seed, t=t, k=k)
    c, o, a, lv = (torch.from_numpy(x).cuda() for x in (counts, origins, attrs, livet))
    gs = [torch.from_numpy(x).cuda() for x in grads]
    fwd0, bwd0 = blend_forward.launches, blend_backward.launches
    a1 = a.clone().requires_grad_()
    out = blend_tiles(c, o, a1, lv, 3, 16, chunk)
    sum((x * g).sum() for x, g in zip(out, gs)).backward()
    torch.cuda.synchronize()
    assert (blend_forward.launches, blend_backward.launches) == (fwd0 + 1, bwd0 + 1)
    a2 = a.clone().requires_grad_()
    ref = blend_tiles_reference(c, o, a2, lv, 3, 16, chunk)
    sum((x * g).sum() for x, g in zip(ref, gs)).backward()
    for x, y in zip(out, ref):
        _mostly_close(x.detach().cpu().numpy(), y.detach().cpu().numpy(),
                      1e-4, 1e-3, 0.005)
    _mostly_close(a1.grad.cpu().numpy(), a2.grad.cpu().numpy(), 2e-4, 1e-3, 0.02)
    # deterministic: no atomics, the same bits on a second run
    color, lang, _, state = blend_forward(c, o, a, lv, 3, 16, chunk)
    again = blend_backward(c, o, a, lv, color, lang, state, *gs, 3, 16, chunk)
    assert torch.equal(again, a1.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("k,chunk", [(2048, 256), (512, 32)])
def test_cuda_blend_is_bitwise_repeatable(k, chunk):
    (c, o, a, lv), gs = _cuda_case(7, 128, k)
    runs = [blend_forward(c, o, a, lv, 3, 16, chunk) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    color, lang, _, state = runs[0]
    grads = [blend_backward(c, o, a, lv, color, lang, state, *gs, 3, 16, chunk)
             for _ in range(2)]
    assert torch.equal(*grads)


@pytest.mark.gpu
def test_cuda_blend_ragged_counts_and_empty_tiles():
    """Counts that are no multiple of a segment's length, tiles with count 0
    (and a negative one), a count past the capacity: against the plain
    version, and the empty tiles blend nothing."""
    (c, o, a, lv), gs = _cuda_case(8, 16, 512)
    c[:, 0] = torch.tensor([0, 1, 33, 65, 100, 255, 257, 0, 511, 512, 700, -3,
                            31, 97, 450, 0], dtype=torch.int32, device="cuda")
    lv = (torch.arange(512, device="cuda")[None, None, :]
          < c.clamp(min=0)[:, :, None]).float().contiguous()
    a1 = a.clone().requires_grad_()
    out = blend_tiles(c, o, a1, lv, 3, 16, 32)
    sum((x * g).sum() for x, g in zip(out, gs)).backward()
    a2 = a.clone().requires_grad_()
    ref = blend_tiles_reference(c, o, a2, lv, 3, 16, 32)
    sum((x * g).sum() for x, g in zip(ref, gs)).backward()
    for x, y in zip(out, ref):
        _mostly_close(x.detach().cpu().numpy(), y.detach().cpu().numpy(),
                      1e-4, 1e-3, 0.005)
    _mostly_close(a1.grad.cpu().numpy(), a2.grad.cpu().numpy(), 2e-4, 1e-3, 0.02)
    empty = (c[:, 0] <= 0).nonzero()[:, 0]
    assert not out[0][empty].any() and not out[2][empty].any()
    assert not a1.grad[empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["random_tiles", "train_16384"])
def test_cuda_blend_backward_with_an_unused_output(frame):
    """Only color and log T enter the loss: the features' cotangent arrives
    as None and the Function hands the kernel zeros. On random tiles and on
    the training frame the port's rasterizer binned."""
    (c, o, a, lv), gs = _cuda_case(9, 64, 2048)
    if frame == "train_16384":
        c, o, a, lv = real_case(frame)[0]
    grads = []
    for fn in (blend_tiles, blend_tiles_reference):
        x = a.clone().requires_grad_()
        color, _, logt = fn(c, o, x, lv, 3, 16, 256)
        ((color * gs[0]).sum() + (logt * gs[2]).sum()).backward()
        grads.append(x.grad.cpu().numpy())
    _mostly_close(*grads, 2e-4, 1e-3, 0.02)


@pytest.mark.gpu
def test_cuda_blend_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    counts, origins, attrs, livet, _ = random_tiles(4, t=4, k=64)
    c, o, a, lv = (torch.from_numpy(x).cuda() for x in (counts, origins, attrs, livet))
    with pytest.raises(ValueError):
        blend_forward(c, o, a[:, :11].contiguous(), lv, 2, 16, 32)   # 2 features
    with pytest.raises(ValueError):
        blend_forward(c, o, a.double(), lv, 3, 16, 32)
    with pytest.raises(ValueError):
        blend_forward(c, o, a, lv, 3, 8, 32)                         # 8×8 tiles


def real_frame(n=16384, hw=128, seed=0, tile_range=None):
    """A real frame's blend inputs (counts, origins, attrs, livet): n random
    Gaussians (the JAX tests' random_scene distribution, drawn with numpy)
    in front of a hw² camera, binned and packed by the port's rasterizer on
    the card (only the tiles of `tile_range`, a rank's window, when
    given)."""
    rng = np.random.default_rng(seed)
    means = np.array([0.0, 0.0, 2.0]) + 0.5 * rng.standard_normal((n, 3))
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 3)))
    q = rng.standard_normal((n, 4))
    rots = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, n)
    shs = 0.3 * rng.standard_normal((n, 4, 3))
    lang = rng.standard_normal((n, 3))
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device="cuda")[None]
    intr = torch.tensor([[hw * 0.95, 0, hw / 2], [0, hw * 0.95, hw / 2],
                         [0, 0, 1]], device="cuda")
    cam = novel_camera_calib(intr[None], torch.eye(4, device="cuda")[None],
                             0.1, 4.0, hw, hw)
    cfg = RasterizeConfig(width=hw, height=hw)
    pre = gm.preprocess(t(means), t(opac), cam, hw, hw, 16, scales=t(scales),
                        rotations=t(rots), shs=t(shs))
    gidx, in_list = tile_lists(pre, cfg, tile_range)[:2]
    with torch.no_grad():
        return pack_tiles(pre, t(lang), gidx, in_list, cfg, 1, tile_range)


def bench_frame():
    """The bench twin's frame (`manigaussian_tpu_torch/bench.py`: 65,536
    Gaussians from seed 0, its 128² camera and RasterizeConfig, K 8192),
    binned and packed by the port's rasterizer on the card."""
    s = bench.make_scene(65536, torch.Generator().manual_seed(0), "cuda")
    cfg = bench.bench_config(128)
    cam = bench.make_camera(128, "cuda")
    cam = type(cam)(*(f[None] for f in cam))
    pre = gm.preprocess(s["means"][None], s["opacities"][None], cam, 128, 128,
                        16, scales=s["scales"][None],
                        rotations=s["rotations"][None], shs=s["shs"][None])
    gidx, in_list = tile_lists(pre, cfg)[:2]
    with torch.no_grad():
        return pack_tiles(pre, s["lang"][None], gidx, in_list, cfg, 1)


def real_case(name):
    """(frame, chunk) of a named real frame."""
    if name == "train_16384":          # 64 tiles × K 2048
        return real_frame(), 256
    if name == "batch2_16384":         # two such frames, 128 tiles
        f0, f1 = real_frame(), real_frame(seed=3)
        return tuple(torch.cat([a, b]) for a, b in zip(f0, f1)), 256
    if name == "micro_k512_chunk32":   # the front-most 512 slots
        c, o, a, lv = real_frame(seed=1)
        return (c, o, a[:, :, :512].contiguous(),
                lv[:, :, :512].contiguous()), 32
    if name == "count0_64px_k256":     # two tiles emptied (count 0)
        c, o, a, lv = real_frame(2048, 64, 2)
        c, lv = c.clone(), lv[:, :, :256].clone()
        c[[0, 5]] = 0
        lv[[0, 5]] = 0
        return (c, o, a[:, :, :256].contiguous(), lv.contiguous()), 256
    if name == "frame_65536":          # full lists and overflow at K 2048
        return real_frame(65536, 128, 4), 256
    if name == "bench_k8192_chunk512":
        return bench_frame(), 512
    raise ValueError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["train_16384", "batch2_16384",
                                  "micro_k512_chunk32", "count0_64px_k256",
                                  "frame_65536", "bench_k8192_chunk512"])
def test_cuda_blend_on_real_frames(name):
    """The blend pair through `blend_tiles` and autograd against the plain
    version on frames the port's rasterizer binned; each kernel bitwise
    repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    (c, o, a, lv), chunk = real_case(name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    gs = [torch.randn(a.shape[0], n, 256, generator=gen, device="cuda")
          for n in (3, 3, 1)]
    a1 = a.clone().requires_grad_()
    out = blend_tiles(c, o, a1, lv, 3, 16, chunk)
    sum((x * g).sum() for x, g in zip(out, gs)).backward()
    a2 = a.clone().requires_grad_()
    ref = blend_tiles_reference(c, o, a2, lv, 3, 16, chunk)
    sum((x * g).sum() for x, g in zip(ref, gs)).backward()
    for x, y in zip(out, ref):
        _mostly_close(x.detach().cpu().numpy(), y.detach().cpu().numpy(),
                      1e-4, 1e-3, 0.005)
    _mostly_close(a1.grad.cpu().numpy(), a2.grad.cpu().numpy(), 2e-4, 1e-3, 0.02)
    runs = [blend_forward(c, o, a, lv, 3, 16, chunk) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    color, lang, _, state = runs[0]
    grads = [blend_backward(c, o, a, lv, color, lang, state, *gs, 3, 16, chunk)
             for _ in range(2)]
    assert torch.equal(*grads)


@pytest.mark.gpu
def test_cuda_blend_on_a_ranks_tile_window():
    """One rank's window of the tile-sharded renderer: tiles 16-31 of the
    64-tile training frame, binned and packed with `tile_range` (global
    pixel origins). The packed live slots, the kernels' outputs and the
    gradient of the window's attributes equal the same tiles of the whole
    frame's bit for bit; against the plain version under the golden
    rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    whole = real_frame()
    part = real_frame(tile_range=(16, 16))
    gen = torch.Generator(device="cuda").manual_seed(5)
    gs = [torch.randn(64, n, 256, generator=gen, device="cuda") for n in (3, 3, 1)]
    gw = [g[16:32] for g in gs]

    def run(fn, frame, grads):
        a = frame[2].clone().requires_grad_()
        out = fn(frame[0], frame[1], a, frame[3], 3, 16, 256)
        sum((x * g).sum() for x, g in zip(out, grads)).backward()
        return [x.detach() for x in out], a.grad

    out_w, grad_w = run(blend_tiles, whole, gs)
    out_p, grad_p = run(blend_tiles, part, gw)
    ref_p, rgrad_p = run(blend_tiles_reference, part, gw)
    # a slot past a tile's list holds whatever follows it in the sorted
    # keys, which the window cuts: the live slots alike
    live = whole[3][16:32] > 0.5
    for x, y in zip((part[0], part[1], part[3]), (whole[0], whole[1], whole[3])):
        assert torch.equal(x, y[16:32])
    assert torch.equal(torch.where(live, part[2], 0.0),
                       torch.where(live, whole[2][16:32], 0.0))
    for x, y in zip(out_p, out_w):
        assert torch.equal(x, y[16:32])
    assert torch.equal(grad_p, grad_w[16:32])
    for x, y in zip(out_p, ref_p):
        _mostly_close(x.cpu().numpy(), y.cpu().numpy(), 1e-4, 1e-3, 0.005)
    _mostly_close(grad_p.cpu().numpy(), rgrad_p.cpu().numpy(), 2e-4, 1e-3, 0.02)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tabletop_dense", "tabletop_sparse"])
def test_cuda_rasterize_matches_the_golden_frames(name):
    """tests/goldens/<name>.npz (frames the JAX package pinned from its
    oracle) rendered on the card through the kernel route: one blend
    forward, no overflow, color, language and final-T frames under the
    golden tests' rule, radii exact. The pinned gradients belong to a loss
    whose weights come from jax.random: the backward is held to the plain
    route above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")
    d = dict(np.load(os.path.join(GOLDENS, name + ".npz")))
    h, w = int(d["height"]), int(d["width"])
    n = d["means3d"].shape[0]
    t = lambda k: torch.tensor(d[k], device="cuda")
    cam = novel_camera_calib(t("intrinsic"), t("c2w"), float(d["znear"]),
                             float(d["zfar"]), h, w)
    cfg = RasterizeConfig(width=w, height=h, tile=16,
                          max_tiles_per_gaussian=(h // 16) * (w // 16),
                          tile_capacity=max(256, ((n + 127) // 128) * 128),
                          chunk=128, sh_degree=1, backend="pallas")
    before = blend_forward.launches
    with torch.no_grad():
        out, extras = rasterize(t("means3d"), t("opacities"), cam, cfg,
                                (0.0, 0.0, 0.0), t("scales"), t("rotations"),
                                t("shs"), t("language_features"))
    torch.cuda.synchronize()
    assert blend_forward.launches == before + 1
    assert int(extras.overflow_splats) == int(extras.overflow_gaussians) == 0
    for field, key in (("color", "golden_color"),
                       ("language_feature", "golden_lang"),
                       ("final_t", "golden_final_t")):
        _mostly_close(getattr(out, field).cpu().numpy(), d[key], 1e-4, 1e-3,
                      0.005)
    assert np.array_equal(out.radii.cpu().numpy(), d["golden_radii"])
