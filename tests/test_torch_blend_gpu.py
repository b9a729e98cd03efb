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
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops.blend import (blend_backward, blend_forward,
                                              blend_tiles,
                                              blend_tiles_reference)


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
def test_cuda_blend_backward_with_an_unused_output():
    """Only color and log T enter the loss: the features' cotangent arrives
    as None and the Function hands the kernel zeros."""
    (c, o, a, lv), gs = _cuda_case(9, 64, 2048)
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
