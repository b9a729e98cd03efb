"""The CUDA tile-blend kernels against their plain PyTorch version, on the
card.

Marked `gpu`: each case skips without a CUDA device. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_blend_gpu.py -m gpu

Tolerances: the JAX golden tests' rules (`assert_mostly_close`): outputs
atol 1e-4 / rtol 1e-3 with at most 0.5 % of elements outside, gradients
atol 2e-4 / rtol 1e-3 with at most 2 % outside. The kernel walks each pixel's
splats one by one, the plain version in chunked prefix sums, so a pixel
whose transmittance sits on the T < 1e-4 latch may flip.
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops.blend import (blend_backward, blend_forward,
                                              blend_tiles,
                                              blend_tiles_reference)


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
                                            (2, 64, 512, 32), (3, 16, 256, 128)])
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
    again = blend_backward(c, o, a, lv, *gs, 3, 16, chunk)
    assert torch.equal(again, a1.grad)


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
