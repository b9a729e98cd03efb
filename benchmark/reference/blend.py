"""Per-tile Gaussian alpha blend, plain PyTorch: a frozen copy of the
port's plain version (`blend_tiles_reference`) and of its packed-attribute
gather. The chunked log-space math follows the TPU kernel; the backward is
autograd of the forward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .voxelize import segment_sum

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
RGB = slice(6, 9)
FEAT0 = 9  # features start here; C = 9 + n_feat
KERNEL_FEATURES = 3  # the feature count csrc/blend.cu is instantiated for
KERNEL_BATCH = 64    # K must be a multiple of it (the wrapper's contract)
KERNEL_SEGMENTS = 8  # segments of a tile's list: the forward's cluster size
SEGMENT_ALIGN = 32   # a segment's length is a multiple of it
STATE_ROWS = 7       # saved per segment: start T, the color and feature sums before it


def _pixel_monomials(tile: int, device) -> torch.Tensor:
    """[P, 6] monomials (1, px, py, px², px·py, py²) of TILE-LOCAL pixels."""
    local = torch.arange(tile * tile, device=device)
    px = (local % tile).float()[:, None]
    py = (local // tile).float()[:, None]
    return torch.cat([torch.ones_like(px), px, py, px * px, px * py, py * py],
                     dim=1)


def _splat_coeffs(xm, ym, ca, cb, cc):
    """[T, 6, CH] power coefficients from [T, CH] rows (conic = (a, b, c))."""
    return torch.stack([
        -0.5 * ca * xm * xm - 0.5 * cc * ym * ym - cb * xm * ym,
        ca * xm + cb * ym,
        cc * ym + cb * xm,
        -0.5 * ca,
        -cb,
        -0.5 * cc,
    ], dim=1)


def blend_tiles_reference(counts: torch.Tensor, origins: torch.Tensor,
                          attrs: torch.Tensor, livet: torch.Tensor,
                          n_feat: int, tile: int = 16, chunk: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: `_fwd_kernel`'s chunk loop for all tiles at once,
    pixel-major [T, P, CH] per chunk. A chunk runs for a tile while
    `chunk·c < count` and not every pixel has latched; otherwise its state
    is carried unchanged (the TPU kernel's `cond`)."""
    t, c_rows, k = attrs.shape
    if c_rows != FEAT0 + n_feat or k % chunk:
        raise ValueError(f"attrs {tuple(attrs.shape)} with n_feat={n_feat}, "
                         f"chunk={chunk}")
    p = tile * tile
    dev = attrs.device
    mono = _pixel_monomials(tile, dev)                            # [P, 6]
    ox, oy = origins[:, 0:1], origins[:, 1:2]                     # [T, 1]
    count = counts.reshape(t, 1)
    alpha_max = torch.tensor(ALPHA_MAX, dtype=torch.float32, device=dev)

    zeros = attrs.new_zeros(t, p)
    log_t_raw, log_t_final = zeros, zeros
    fail_any = torch.zeros(t, p, dtype=torch.bool, device=dev)
    color_acc = attrs.new_zeros(t, 3, p)
    lang_acc = attrs.new_zeros(t, n_feat, p)
    for c in range(k // chunk):
        run = (c * chunk < count[:, 0]) & ~fail_any.all(dim=1)    # [T]
        if not bool(run.any()):
            continue
        sl = slice(c * chunk, (c + 1) * chunk)
        a_rows = attrs[:, :, sl]                                  # [T, C, CH]
        xm, ym = a_rows[:, 0] - ox, a_rows[:, 1] - oy
        coeff = _splat_coeffs(xm, ym, a_rows[:, 2], a_rows[:, 3], a_rows[:, 4])
        power = torch.matmul(mono, coeff)                         # [T, P, CH]
        g = torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.minimum(a_rows[:, 5:6] * g, alpha_max)
        active = (power <= 0.0) & (alpha >= ALPHA_MIN) & (livet[:, :, sl] > 0.5)
        a = torch.where(active, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-a)
        csum = torch.cumsum(log1m, dim=2)
        t_before = torch.exp(csum - log1m + log_t_raw[:, :, None])
        fail = t_before * (1.0 - a) < T_EPS
        fail_i = fail.to(torch.int32)
        term_before = ((torch.cumsum(fail_i, dim=2) - fail_i) > 0) \
            | fail_any[:, :, None]
        contrib = ~term_before & ~fail
        w = torch.where(contrib, a * t_before, torch.zeros_like(a))
        new_color = color_acc + torch.einsum("tpk,tck->tcp", w, a_rows[:, RGB])
        new_lang = lang_acc + torch.einsum("tpk,tck->tcp", w, a_rows[:, FEAT0:])
        new_final = log_t_final + torch.where(
            contrib, log1m, torch.zeros_like(log1m)).sum(dim=2)
        new_raw = log_t_raw + csum[:, :, -1]
        new_fail = fail_any | fail.any(dim=2)
        r2, r3 = run[:, None], run[:, None, None]
        color_acc = torch.where(r3, new_color, color_acc)
        lang_acc = torch.where(r3, new_lang, lang_acc)
        log_t_final = torch.where(r2, new_final, log_t_final)
        log_t_raw = torch.where(r2, new_raw, log_t_raw)
        fail_any = torch.where(r2, new_fail, fail_any)
    return color_acc, lang_acc, log_t_final[:, None, :]


# --------------------------------------------------------------- the gather
class _GatherSplats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, gidx):
        ctx.save_for_backward(gidx)
        ctx.n = table.shape[1]
        return table[:, gidx]

    @staticmethod
    def backward(ctx, g):
        (gidx,) = ctx.saved_tensors
        c = g.shape[0]
        rows = g.reshape(c, -1).t()                                # [T·K, C]
        return segment_sum(rows, gidx.reshape(-1), ctx.n).t(), None


def gather_splats(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """table [C, N] → [C, T, K] via gidx [T, K], with the deterministic
    segment-sum backward described above."""
    return _GatherSplats.apply(table, gidx)
