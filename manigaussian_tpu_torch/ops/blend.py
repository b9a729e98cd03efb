"""Per-tile Gaussian alpha blend: the wrappers of the CUDA kernels (forward
and backward), their plain PyTorch version, and the packed-attribute gather.

Counterpart of `manigaussian_tpu/ops/pallas_blend.py`. The kernels
(`csrc/blend.cu`) replace its TPU kernels `_fwd_kernel` (through
`_blend_fwd`) and `_bwd_kernel` (through `_blend_bwd`); the bound and the
design are noted in the source. `blend_tiles` is an autograd Function on
CUDA tensors (forward kernel, then backward kernel); on CPU tensors it runs
the plain version, which follows the TPU kernel's chunked log-space math
(`_chunk_state`, tile-local monomials) and whose backward is autograd of that
forward: `where`-gated, it has the JAX VJP's semantics (zero gradient at the
0.99 clamp, for skipped splats and for latched pixels).

`gather_splats` (table [C, N] → [C, T, K]) has a deterministic backward: a
stable sort of the gather indices and a segment sum into [C, N]
(`ops/voxelize.segment_sum`), never `index_add_` (whose CUDA accumulation
order changes from run to run).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from manigaussian_tpu_torch.ops import _cuda
from manigaussian_tpu_torch.ops.voxelize import segment_sum

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
RGB = slice(6, 9)
FEAT0 = 9  # features start here; C = 9 + n_feat
KERNEL_FEATURES = 3  # the feature count csrc/blend.cu is instantiated for
KERNEL_BATCH = 64    # splats the kernels stage at a time (K must be a multiple)


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


def _library() -> ctypes.CDLL:
    lib = _cuda.load("blend")
    if lib.blend_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.blend_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.blend_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.blend_fwd.restype = lib.blend_bwd.restype = i32
    return lib


def _check(counts, origins, attrs, livet, n_feat, tile, chunk, *grads):
    t, c_rows, k = attrs.shape
    if attrs.device.type != "cuda":
        raise ValueError(f"the blend kernels take CUDA tensors, got {attrs.device}")
    if n_feat != KERNEL_FEATURES or c_rows != FEAT0 + n_feat:
        raise ValueError(f"the blend kernels take {KERNEL_FEATURES} features "
                         f"(attrs [T, 12, K]), got n_feat={n_feat}, "
                         f"attrs {tuple(attrs.shape)}")
    if tile != 16:
        raise ValueError(f"the blend kernels take 16×16 tiles, got {tile}")
    if k % KERNEL_BATCH or chunk % 4 or k % chunk:
        raise ValueError(f"capacity {k} must be a multiple of {KERNEL_BATCH} "
                         f"and of the chunk {chunk} (a multiple of 4)")
    expect = [("counts", counts, (t, 1), torch.int32),
              ("origins", origins, (t, 2), torch.float32),
              ("attrs", attrs, (t, c_rows, k), torch.float32),
              ("livet", livet, (t, 1, k), torch.float32)]
    names = ("gcolor", "glang", "glogtf")
    shapes = ((t, 3, tile * tile), (t, n_feat, tile * tile), (t, 1, tile * tile))
    expect += [(nm, g, s, torch.float32) for nm, g, s in zip(names, grads, shapes)]
    for name, x, shape, dtype in expect:
        if (tuple(x.shape) != shape or x.dtype != dtype or x.device != attrs.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} {shape} on {attrs.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def blend_forward(counts, origins, attrs, livet, n_feat: int, tile: int = 16,
                  chunk: int = 256):
    """Launch the forward kernel: (color [T,3,P], lang [T,F,P],
    log_t_final [T,1,P])."""
    _check(counts, origins, attrs, livet, n_feat, tile, chunk)
    t, _, k = attrs.shape
    p = tile * tile
    color = attrs.new_empty(t, 3, p)
    lang = attrs.new_empty(t, n_feat, p)
    logtf = attrs.new_empty(t, 1, p)
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().blend_fwd(
            counts.data_ptr(), origins.data_ptr(), attrs.data_ptr(),
            livet.data_ptr(), color.data_ptr(), lang.data_ptr(),
            logtf.data_ptr(), t, n_feat, k, chunk, stream)
    if err:
        raise RuntimeError(f"blend forward kernel launch failed: CUDA error {err}")
    blend_forward.launches += 1
    return color, lang, logtf


def blend_backward(counts, origins, attrs, livet, gcolor, glang, glogtf,
                   n_feat: int, tile: int = 16, chunk: int = 256):
    """Launch the backward kernel: dattrs [T, C, K]."""
    _check(counts, origins, attrs, livet, n_feat, tile, chunk,
           gcolor, glang, glogtf)
    t, _, k = attrs.shape
    dattrs = torch.zeros_like(attrs)
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().blend_bwd(
            counts.data_ptr(), origins.data_ptr(), attrs.data_ptr(),
            livet.data_ptr(), gcolor.data_ptr(), glang.data_ptr(),
            glogtf.data_ptr(), dattrs.data_ptr(), t, n_feat, k, chunk, stream)
    if err:
        raise RuntimeError(f"blend backward kernel launch failed: CUDA error {err}")
    blend_backward.launches += 1
    return dattrs


class _BlendTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, origins, attrs, livet, n_feat, tile, chunk):
        ctx.save_for_backward(counts, origins, attrs, livet)
        ctx.args = (n_feat, tile, chunk)
        return blend_forward(counts, origins, attrs, livet, n_feat, tile, chunk)

    @staticmethod
    def backward(ctx, *grads):
        counts, origins, attrs, livet = ctx.saved_tensors
        n_feat, tile, chunk = ctx.args
        rows = (3, n_feat, 1)   # an unused output's gradient arrives as None
        grads = [attrs.new_zeros(attrs.shape[0], r, tile * tile) if g is None
                 else g.contiguous() for g, r in zip(grads, rows)]
        dattrs = blend_backward(counts, origins, attrs, livet, *grads, *ctx.args)
        return None, None, dattrs, None, None, None, None


def blend_tiles(counts: torch.Tensor, origins: torch.Tensor,
                attrs: torch.Tensor, livet: torch.Tensor, n_feat: int,
                tile: int = 16, chunk: int = 256):
    """Differentiable per-tile blend (the JAX `blend_tiles_pallas`).

    counts [T,1] int32 (early-exit bound), origins [T,2] f32 tile pixel
    origins, attrs [T,C,K] f32 packed per-splat attributes (rows: xy 2,
    conic 3, opacity 1, rgb 3, features n_feat), livet [T,1,K] f32 0/1.
    Returns (color [T,3,P], lang [T,F,P], log_t_final [T,1,P]); the caller
    applies exp() and the background composite. Gradients flow to attrs only.
    """
    if attrs.device.type == "cpu":
        return blend_tiles_reference(counts, origins, attrs, livet, n_feat,
                                     tile, chunk)
    return _BlendTiles.apply(counts, origins, attrs, livet, n_feat, tile, chunk)


# launches of the CUDA kernels (the plain version is not counted)
blend_forward.launches = 0
blend_backward.launches = 0


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
