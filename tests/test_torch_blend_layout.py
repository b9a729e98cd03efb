"""The decompositions the tile-blend kernels (csrc/blend.cu) rely on, rebuilt
in plain tensor code on the CPU and held to the plain version
`blend_tiles_reference`, to autograd of it and to the JAX
`blend_tiles_pallas` in interpret mode.

* The segmented forward: each segment's Π(1 − a), the exclusive product in
  segment order as each segment's start T, a walk of the segment from its
  start T under the latch rule, and the partials combined in segment order
  (1, 2, 3 and 8 segments, latched pixels present).
* The one-sweep backward: each segment walked once from the forward's
  outputs and its start state (start T, the color and feature sums before
  it), against autograd of the plain version.
* The conservative pixel box (`splat_box`) and the warps' rectangles
  (`warp_rects`): no pair whose alpha reaches 1/255 lies outside the box,
  for ordinary, near-degenerate and indefinite conics and opacities around
  1/255, and a warp walks every splat whose box meets its rectangle;
  skipping the pairs it does not walk changes no output bit.
* The host's planning functions (`walk_end`, `segment_bounds`,
  `warp_rects`).

Tolerances: the JAX golden tests' rules (outputs atol 1e-4 / rtol 1e-3 with
≤ 0.5 % outside, gradients atol 2e-4 / rtol 1e-3 with ≤ 2 % outside): the
segments multiply and sum in another order than the plain version's chunked
log-space sums, so a pixel whose T sits on the 1e-4 latch may flip.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.ops.pallas_blend import blend_tiles_pallas
from manigaussian_tpu_torch.ops import blend as B
from tests.helpers import assert_mostly_close
from tests.test_torch_blend_gpu import random_tiles

K, T_TILES, CHUNK = 256, 6, 32


@functools.lru_cache(maxsize=None)
def _case(seed):
    """Random tiles whose lists span 8 segments of 32, the plain version's
    outputs and gradient, and the JAX kernel's outputs."""
    counts, origins, attrs, livet, grads = random_tiles(seed, t=T_TILES, k=K)
    jout = blend_tiles_pallas(jnp.asarray(counts), jnp.asarray(origins),
                              jnp.asarray(attrs), jnp.asarray(livet), 3,
                              (16, CHUNK, True))
    ta = torch.from_numpy(attrs).requires_grad_()
    ref = B.blend_tiles_reference(torch.from_numpy(counts),
                                  torch.from_numpy(origins), ta,
                                  torch.from_numpy(livet), 3, 16, CHUNK)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(ref, grads))
    (dref,) = torch.autograd.grad(loss, ta)
    return (counts, origins, attrs, livet, grads,
            [np.asarray(o) for o in jout], [o.detach() for o in ref], dref)


def _pairs(counts, origins, attrs, livet, chunk):
    """Per tile and pair, as the plain version evaluates them: [T, P, K]
    power, g, unclamped alpha and the effective alpha a (0 where skipped,
    not live or past the tile's walk end)."""
    a_t = torch.from_numpy(attrs)
    t, _, k = a_t.shape
    mono = B._pixel_monomials(16, "cpu")
    org = torch.from_numpy(origins)
    xm, ym = a_t[:, 0] - org[:, 0:1], a_t[:, 1] - org[:, 1:2]
    coeff = B._splat_coeffs(xm, ym, a_t[:, 2], a_t[:, 3], a_t[:, 4])
    power = torch.matmul(mono, coeff)
    g = torch.exp(torch.clamp(power, max=0.0))
    alpha_un = a_t[:, 5:6] * g
    alpha = torch.clamp(alpha_un, max=B.ALPHA_MAX)
    ends = torch.tensor([B.walk_end(int(c), k, chunk) for c in counts[:, 0]])
    walked = torch.arange(k)[None, :] < ends[:, None]
    live = (torch.from_numpy(livet)[:, 0] > 0.5) & walked
    active = (power <= 0) & (alpha >= B.ALPHA_MIN) & live[:, None, :]
    a = torch.where(active, alpha, torch.zeros_like(alpha))
    return power, g, alpha_un, a, ends


def forward_by_segments(a, vals, n_end, segments):
    """One tile as the forward kernel decomposes it: a [P, K] effective
    alphas, vals [6, K] rgb and features. Returns color [3, P], features
    [3, P], log T [P] and each segment's start state (T, sums before it)."""
    bounds = B.segment_bounds(n_end, segments)
    # sweep A: each segment's product, no latch
    prods = [torch.prod(1.0 - a[:, lo:hi], dim=1) for lo, hi in bounds]
    starts, run = [], torch.ones(a.shape[0])
    for p in prods:
        starts.append(run)
        run = run * p
    # sweep B: each segment from its start T under the latch rule
    partial, t_out, latched = [], [], []
    for (lo, hi), t0 in zip(bounds, starts):
        tr, lat = t0.clone(), t0 < B.T_EPS
        acc = torch.zeros(6, a.shape[0])
        for k in range(lo, hi):
            ak = a[:, k]
            tn = tr * (1.0 - ak)
            trip = tn < B.T_EPS
            contrib = ~lat & ~trip
            lat = lat | trip
            w = torch.where(contrib, ak * tr, torch.zeros_like(ak))
            acc = acc + w[None, :] * vals[:, k:k + 1]
            tr = torch.where(contrib, tn, tr)
        partial.append(acc)
        t_out.append(tr)
        latched.append(lat)
    # the ordered combine
    total, prefix = torch.zeros(6, a.shape[0]), []
    t_end, found = t_out[0].clone(), latched[0].clone()
    for s in range(segments):
        prefix.append(total)
        total = total + partial[s]
        if s:
            t_end = torch.where(found, t_end, t_out[s])
            found = found | latched[s]
    return total[:3], total[3:], torch.log(t_end), starts, prefix


def segmented_forward(counts, origins, attrs, livet, segments, chunk=CHUNK,
                      a=None):
    power, g, alpha_un, a_ref, ends = _pairs(counts, origins, attrs, livet, chunk)
    a = a_ref if a is None else a
    vals = torch.from_numpy(attrs)[:, 6:12]
    outs = [forward_by_segments(a[t], vals[t], int(ends[t]), segments)
            for t in range(a.shape[0])]
    color = torch.stack([o[0] for o in outs])
    lang = torch.stack([o[1] for o in outs])
    logt = torch.stack([o[2] for o in outs])[:, None, :]
    return (color, lang, logt), outs


@pytest.mark.parametrize("segments", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_forward_matches_plain_and_pallas(seed, segments):
    counts, origins, attrs, livet, _, jout, ref, _ = _case(seed)
    out, _ = segmented_forward(counts, origins, attrs, livet, segments)
    for name, o, r, j in zip(("color", "lang", "log_t"), out, ref, jout):
        assert_mostly_close(o.numpy(), r.numpy(), atol=1e-4, rtol=1e-3,
                            err_msg=f"{name} vs plain")
        assert_mostly_close(o.numpy(), j, atol=1e-4, rtol=1e-3,
                            err_msg=f"{name} vs pallas")
    # latched pixels exist, and with 8 segments so do segments that start
    # latched and lists cut into many nonempty segments
    assert (ref[2] < math.log(1e-3)).any()
    ends = [B.walk_end(int(c), K, CHUNK) for c in counts[:, 0]]
    assert max(sum(hi > lo for lo, hi in B.segment_bounds(e, 8)) for e in ends) == 8


def backward_by_segments(attrs_t, origin, power, g, alpha_un, a, n_end,
                         color, lang, starts, prefix, gc, gl, glt, segments):
    """One tile's dattrs [C, K] as the backward kernel computes it: each
    segment walked once from its start T, the prefix Σ w·g started from the
    sums before it and the total from the outputs; per-splat sums over the
    tile's pixels and the closed forms for d{x, y, conic}."""
    mono = B._pixel_monomials(16, "cpu")
    px, py = mono[:, 1], mono[:, 2]
    total = (gc * color).sum(0) + (gl * lang).sum(0)
    out = torch.zeros_like(attrs_t)
    for s, (lo, hi) in enumerate(B.segment_bounds(n_end, segments)):
        tr = starts[s].clone()
        pre_run = (gc * prefix[s][:3]).sum(0) + (gl * prefix[s][3:]).sum(0)
        lat = tr < B.T_EPS
        for k in range(lo, hi):
            ak = a[:, k]
            tn = tr * (1.0 - ak)
            trip = tn < B.T_EPS
            contrib = ~lat & ~trip & (ak > 0)
            lat = lat | trip
            gs = (gc * attrs_t[6:9, k:k + 1]).sum(0) + (gl * attrs_t[9:, k:k + 1]).sum(0)
            w = ak * tr
            pre = pre_run + w * gs
            da = tr * gs - (total - pre + glt) / (1.0 - ak)
            dao = torch.where(contrib & (alpha_un[:, k] < B.ALPHA_MAX), da,
                              torch.zeros_like(da))
            wc = torch.where(contrib, w, torch.zeros_like(w))
            dpow = dao * alpha_un[:, k]
            d1, dpx, dpy = dpow.sum(), (dpow * px).sum(), (dpow * py).sum()
            dpx2, dpxpy = (dpow * px * px).sum(), (dpow * px * py).sum()
            dpy2 = (dpow * py * py).sum()
            xm, ym = attrs_t[0, k] - origin[0], attrs_t[1, k] - origin[1]
            ca, cb, cc = attrs_t[2, k], attrs_t[3, k], attrs_t[4, k]
            out[0, k] = d1 * (-ca * xm - cb * ym) + dpx * ca + dpy * cb
            out[1, k] = d1 * (-cc * ym - cb * xm) + dpy * cc + dpx * cb
            out[2, k] = d1 * (-0.5 * xm * xm) + dpx * xm - 0.5 * dpx2
            out[3, k] = d1 * (-xm * ym) + dpx * ym + dpy * xm - dpxpy
            out[4, k] = d1 * (-0.5 * ym * ym) + dpy * ym - 0.5 * dpy2
            out[5, k] = (dao * g[:, k]).sum()
            out[6:9, k] = (gc * wc).sum(1)
            out[9:, k] = (gl * wc).sum(1)
            pre_run = torch.where(contrib, pre, pre_run)
            tr = torch.where(contrib, tn, tr)
    return out


@pytest.mark.parametrize("segments", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_sweep_backward_matches_autograd_of_plain(seed, segments):
    counts, origins, attrs, livet, grads, _, _, dref = _case(seed)
    power, g, alpha_un, a, ends = _pairs(counts, origins, attrs, livet, CHUNK)
    _, outs = segmented_forward(counts, origins, attrs, livet, segments)
    at = torch.from_numpy(attrs)
    gc, gl, glt = (torch.from_numpy(x) for x in grads)
    d = torch.stack([
        backward_by_segments(at[t], origins[t], power[t], g[t], alpha_un[t],
                             a[t], int(ends[t]), outs[t][0], outs[t][1],
                             outs[t][3], outs[t][4], gc[t], gl[t], glt[t, 0],
                             segments)
        for t in range(at.shape[0])])
    assert_mostly_close(d.numpy(), dref.numpy(), atol=2e-4, rtol=1e-3,
                        max_frac=0.02, err_msg="dattrs")
    assert dref.abs().max() > 1e-2      # the gradient is not trivially zero


def _random_splats(rng, n, regime):
    """n splats at tile-local positions around a 16×16 tile: conics of
    ordinary, near-degenerate or indefinite shape; opacities spread over
    [1e-4, 1] with some on either side of 1/255."""
    xm, ym = rng.uniform(-24, 40, (2, n))
    sx, sy = np.exp(rng.uniform(np.log(0.3), np.log(12.0), (2, n)))
    if regime == "near_degenerate":
        rho = rng.choice([-1, 1], n) * (1 - 10.0 ** rng.uniform(-6, -2, n))
    else:
        rho = rng.uniform(-0.95, 0.95, n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    ca, cb, cc = sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det
    if regime == "indefinite":
        cb = np.sqrt(ca * cc) * rng.uniform(1.0, 1.5, n) * rng.choice([-1, 1], n)
    op = np.exp(rng.uniform(np.log(1e-4), 0.0, n))
    op[: n // 8] = (1 / 255) * (1 + rng.uniform(-1e-5, 1e-5, n // 8))
    return [np.asarray(x, np.float32) for x in (xm, ym, ca, cb, cc, op)]


def _alpha_active(xm, ym, ca, cb, cc, op, how):
    """[N, 16, 16] (row, column) where alpha ≥ 1/255 and power ≤ 0: as the
    plain version evaluates it (float32 monomials), in float64, and as the
    kernel factors it (float32, log2 units, x part first)."""
    py, px = np.meshgrid(np.arange(16.0), np.arange(16.0), indexing="ij")
    if how == "float64":
        f = lambda x: np.asarray(x, np.float64)[:, None, None]
        dx, dy = px[None] - f(xm), py[None] - f(ym)
        power = -0.5 * (f(ca) * dx * dx + f(cc) * dy * dy) - f(cb) * dx * dy
        alpha = np.minimum(f(op) * np.exp(np.minimum(power, 0)), 0.99)
        return (power <= 0) & (alpha >= np.float32(B.ALPHA_MIN))
    t = torch.from_numpy
    c = B._splat_coeffs(t(xm), t(ym), t(ca), t(cb), t(cc))         # [N, 6]
    pxt, pyt = torch.from_numpy(px).float(), torch.from_numpy(py).float()
    if how == "plain":
        mono = torch.stack([torch.ones_like(pxt), pxt, pyt, pxt * pxt,
                            pxt * pyt, pyt * pyt], -1)            # [16, 16, 6]
        power = torch.einsum("rcm,nm->nrc", mono, c)
        g = torch.exp(torch.clamp(power, max=0.0))
    else:
        c2 = [x[:, None, None] for x in (c * math.log2(math.e)).unbind(1)]
        base = c2[0] + c2[1] * pxt + c2[3] * pxt * pxt
        slope = c2[2] + c2[4] * pxt
        power = (c2[5] * pyt + slope) * pyt + base
        g = torch.exp2(power)
    alpha = torch.clamp(t(op)[:, None, None] * g, max=B.ALPHA_MAX)
    return ((power <= 0) & (alpha >= B.ALPHA_MIN)).numpy()


def _warp_of_pixel():
    """[16, 16] (row, column) → the warp whose rectangle holds the pixel."""
    owner = np.zeros((16, 16), np.int64)
    for w, (x0, x1, y0, y1) in enumerate(B.warp_rects()):
        owner[y0:y1 + 1, x0:x1 + 1] = w
    return owner


def _walked(box):
    """[N, 16, 16] pairs a warp walks: those whose warp rectangle meets the
    splat's box (`Layout::meets` in csrc/blend.cu)."""
    x0, x1, y0, y1 = (b.numpy()[:, None] for b in box)
    rects = np.array(B.warp_rects())                               # [W, 4]
    meets = ((x0 <= rects[None, :, 1]) & (x1 >= rects[None, :, 0])
             & (y0 <= rects[None, :, 3]) & (y1 >= rects[None, :, 2]))  # [N, W]
    return meets[:, _warp_of_pixel()]


@pytest.mark.parametrize("seed", [1, 2, 4, 8])
@pytest.mark.parametrize("regime", ["ordinary", "near_degenerate", "indefinite"])
def test_pixel_box_is_conservative(regime, seed):
    rng = np.random.default_rng(
        ["ordinary", "near_degenerate", "indefinite"].index(regime) * 10 + seed)
    sp = _random_splats(rng, 3000, regime)
    box = B.splat_box(*sp)
    x0, x1, y0, y1 = (b.numpy()[:, None, None] for b in box)
    py, px = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)     # [N, 16, 16]
    walked = _walked(box)
    assert not (inside & ~walked).any()
    for how in ("plain", "float64", "kernel"):
        active = _alpha_active(*sp, how)
        assert not (active & ~inside).any(), (how, np.argwhere(active & ~inside)[:5])
    low = sp[5] < np.float32(B.ALPHA_MIN) * (1 - 2.0 ** -20)
    assert (box[0].numpy()[low] == B.NO_BOX).all()
    if regime == "ordinary":           # the rule does cull: it is not vacuous
        assert (~inside).mean() > 0.5
    if regime == "indefinite":         # never culled but for opacity < 1/255
        assert inside[~low].all()


@pytest.mark.parametrize("seed", [7, 8])
def test_skipping_pairs_outside_the_box_changes_no_output_bit(seed):
    counts, origins, attrs, livet, _ = random_tiles(seed, t=T_TILES, k=K)
    rng = np.random.default_rng(seed + 4)
    # mix in near-degenerate, indefinite and faint splats
    sp = _random_splats(rng, K, "near_degenerate")
    sel = rng.uniform(size=(T_TILES, K)) < 0.2
    for row, x in zip((2, 3, 4), sp[2:5]):
        attrs[:, row][sel] = np.broadcast_to(x, (T_TILES, K))[sel]
    faint = rng.uniform(size=(T_TILES, K)) < 0.1
    attrs[:, 5][faint] = rng.uniform(1e-4, 8e-3, faint.sum())
    _, _, _, a, _ = _pairs(counts, origins, attrs, livet, CHUNK)
    box = B.splat_box(attrs[:, 0] - origins[:, 0:1], attrs[:, 1] - origins[:, 1:2],
                      attrs[:, 2], attrs[:, 3], attrs[:, 4], attrs[:, 5])
    walked = _walked([b.reshape(-1) for b in box])
    keep = torch.from_numpy(walked.reshape(T_TILES, K, 256)).permute(0, 2, 1)
    culled = torch.where(keep, a, torch.zeros_like(a))
    assert torch.equal(culled, a)
    live = (torch.from_numpy(livet) > 0.5).expand_as(keep)
    assert (~keep & live).sum() > 0.1 * live.sum()     # the rule does cull
    full, _ = segmented_forward(counts, origins, attrs, livet, 8)
    skipped, _ = segmented_forward(counts, origins, attrs, livet, 8, a=culled)
    for x, y in zip(full, skipped):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k,chunk", [(2048, 256), (512, 32), (256, 64), (64, 4)])
def test_walk_end_and_segment_bounds(k, chunk):
    for count in sorted({0, 1, chunk - 1, chunk, chunk + 1, k // 3, k - 1, k, k + 5}):
        n_end = B.walk_end(count, k, chunk)
        assert n_end == min(k, math.ceil(max(count, 0) / chunk) * chunk)
        for segments in (1, 2, 4, 8):
            bounds = B.segment_bounds(n_end, segments)
            assert len(bounds) == segments
            # contiguous, in order, covering [0, n_end) exactly
            assert bounds[0][0] == 0 and bounds[-1][1] == n_end
            assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
            length = bounds[0][1] - bounds[0][0]
            assert length % B.SEGMENT_ALIGN == 0 or n_end < B.SEGMENT_ALIGN
            assert all(hi - lo <= max(length, n_end) for lo, hi in bounds)
            assert segments * length >= n_end


def test_warp_rects_tile_the_tile_once():
    owner = np.zeros((16, 16), np.int64)
    for x0, x1, y0, y1 in B.warp_rects():
        assert (x1 - x0 + 1) * (y1 - y0 + 1) == 64      # 32 lanes × 2 pixels
        owner[y0:y1 + 1, x0:x1 + 1] += 1
    assert (owner == 1).all() and len(B.warp_rects()) == 4
