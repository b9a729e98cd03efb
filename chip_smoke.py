"""Chip smoke test of the PyTorch/CUDA port (`manigaussian_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. build       — compile every CUDA source of the port with nvcc (sm_90a),
                   one process per source, and print ptxas's register report;
  2. kernels     — hold each kernel against its plain PyTorch version on the
                   card at the main paths' shapes and a few ragged ones: the
                   flash forward (without and with dropout, the same hashed
                   mask) and backward (dq, dk, dv against autograd of the
                   plain version), the tile blend forward and backward on the
                   tiles of a real frame (16,384 random Gaussians in a 128²
                   view, binned by the port's rasterizer); then `golden`: the
                   JAX package's pinned frames (tests/goldens/*.npz, read with
                   numpy) rendered through the kernel route; then time each
                   kernel, its plain version and the PyTorch call that
                   computes the same function (a yardstick only; the port
                   never calls it), and F.conv3d and its weight gradient at
                   the shapes of the TPU conv kernels the port has not ported;
  3. small       — references on small inputs, the card against the CPU (the
                   plain versions, which tests/test_torch_*.py hold to the JAX
                   package): voxelize on cell boundaries, the micro config's
                   act in fp32 and bf16, and `small_train`: the micro
                   config's `update` in fp32, dropout 0, the same draws;
  4. slice       — the act/eval path at the full width of `config.w_geo()`
                   (V=100, 2048×512 latents, 6 layers of 8×64 heads, bf16, one
                   128² front camera), random weights from seed 0, through the
                   port's eval entry point on the mock env; the counts are set
                   to 0 just before and read just after: `transformer_depth`
                   flash forwards per act;
  5. routes      — act on the kernel route and the plain route: Q values,
                   latency, memory; torch.profiler over act calls;
  6. train_slice — the training path at full `w_geo` width through
                   `python -m manigaussian_tpu_torch.train`'s main(): two
                   synthetic demos at 128² with nerf views, batch 1, 8 steps,
                   a checkpoint, then a resume; the counts are set to 0 just
                   before and read just after: per step `transformer_depth`
                   flash forwards and backwards, 1 blend forward and 1 blend
                   backward; finite losses; step time and peak memory;
  7. train_routes — one batch from the same weights through the kernel route
                   (flash + pallas) and the plain route (xla + xla), dropout
                   0 and fixed draws: loss and gradient norm, the step time
                   of each route, and torch.profiler over 2 training steps.
Then one JSON line of kernel records, the card's name and power limit, and
last, the device line.

Nothing of JAX is imported. Scratch files go under build/chip_smoke/ in the
checkout. With no CUDA device, or without the package beside it, the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 without
# tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# special-function-unit results a second (exp, log): 16 a clock on each of
# the 132 SMs (4 SFUs in each of an SM's 4 partitions, Hopper architecture
# white paper) at the 1.98 GHz boost clock
PEAK_SFU = 132 * 16 * 1.98e9
# the blend's work per (splat, pixel) pair: the forward's exp and log1p,
# ≈ 20 fp32 operations (power, alpha, gates, weight, 6 accumulators); the
# backward replays the forward twice and adds the suffix-sum gradient and
# its 13 per-splat sums (≈ 60 fp32 operations)
BLEND_SFU = {"fwd": 2, "bwd": 4}
BLEND_FLOPS = {"fwd": 20, "bwd": 60}

# The kernel route and the plain route differ only in where bf16 rounds
# inside attention (unnormalized vs normalized probabilities, summation
# order); through 6 residual layers, the decoder and the 100³ convs that
# stays a few bf16 steps (2^-8 relative each) of the Q-values' scale.
ROUTE_TOL = 5e-2


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def mostly_close(actual, desired, atol: float, rtol: float,
                 max_frac: float = 0.005):
    """The JAX golden tests' rule (tests/helpers.assert_mostly_close): at
    most `max_frac` of the elements outside atol/rtol, as a splat sitting on
    the 1/255 or T < 1e-4 threshold may flip between two summation orders.
    Returns (ok, fraction outside, max abs diff)."""
    import numpy as np
    a = np.asarray(actual, np.float64)
    d = np.asarray(desired, np.float64)
    bad = ~np.isclose(a, d, atol=atol, rtol=rtol)
    return (float(bad.mean()) <= max_frac, float(bad.mean()),
            float(np.abs(a - d).max()) if a.size else 0.0)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of operations over the peak rate and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    from manigaussian_tpu_torch.ops import _cuda
    names = sorted(p[:-3] for p in os.listdir(_cuda.CSRC) if p.endswith(".cu"))
    t0 = time.time()
    _cuda.build(names)
    report = []
    for name in names:
        text = _cuda.library_path(name).with_suffix(".log").read_text()
        report += [ln.strip() for ln in text.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log("build", sources=names, seconds=round(time.time() - t0, 3),
        ptxas=report)


def phase_flash() -> dict:
    """The flash forward (with and without dropout) and backward against the
    plain version; then their times at the policy's shape."""
    import torch
    import torch.nn.functional as F
    from manigaussian_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_self_attention,
        flash_self_attention_backward, flash_self_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (dtype, N, head dim, dropout rate, forward tolerance); the backward's
    # tolerance: bf16 2e-2·max(1, max|ref|), fp32 1e-4·max(1, max|ref|)
    # (sums over N keys in another order)
    checks = [("bfloat16", 2048, 64, 0.0, 2e-2), ("bfloat16", 2048, 64, 0.1, 2e-2),
              ("float32", 2048, 64, 0.0, 1e-5), ("float32", 512, 64, 0.1, 1e-5),
              ("bfloat16", 256, 64, 0.1, 2e-2), ("bfloat16", 512, 32, 0.0, 2e-2),
              ("bfloat16", 100, 16, 0.0, 2e-2), ("float32", 32, 8, 0.1, 1e-5)]
    errs = {}
    for dtype, n, d, rate, tol in checks:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(1, 8, n, d, generator=gen, device="cuda").to(dt)
                   .requires_grad_() for _ in range(3))
        bq = 256 if n % 256 == 0 else n
        seed = 1234
        out = flash_self_attention(q, k, v, rate, torch.tensor([seed]), bq)
        g = torch.randn(out.shape, generator=gen, device="cuda")
        grads = torch.autograd.grad((out.float() * g).sum(), (q, k, v))
        ref = flash_self_attention_reference(q, k, v, rate, seed, bq)
        rgrads = torch.autograd.grad((ref.float() * g).sum(), (q, k, v))
        torch.cuda.synchronize()
        fwd_err = (out.float() - ref.float()).abs().max().item()
        btol = 2e-2 if dtype == "bfloat16" else 1e-4
        bwd = {}
        for name, a, b in zip(("dq", "dk", "dv"), grads, rgrads):
            scale = max(1.0, b.float().abs().max().item())
            bwd[name] = (a.float() - b.float()).abs().max().item() / scale
        ok = (bool(torch.isfinite(out).all()) and fwd_err <= tol
              and all(e <= btol for e in bwd.values()))
        log("kernel_check", kernel="flash_self_attention", dtype=dtype,
            shape=[1, 8, n, d], dropout=rate, max_abs_err=fwd_err, tol=tol,
            bwd_err_over_scale=bwd, bwd_tol=btol, ok=ok)
        if not ok:
            raise AssertionError(f"flash kernels disagree: {dtype} n={n} d={d} "
                                 f"rate={rate} fwd={fwd_err} bwd={bwd}")
        if (dtype, n, d, rate) == ("bfloat16", 2048, 64, 0.1):
            errs = {"fwd": fwd_err, "bwd": max(bwd.values()) * max(
                1.0, max(b.float().abs().max().item() for b in rgrads))}

    # times at the training step's shape (bf16, dropout 0.1 as in training)
    n, d, bh = 2048, 64, 8
    q, k, v, g = (torch.randn(1, 8, n, d, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    sd = torch.tensor([1234])
    out, lse = flash_attention_forward(q, k, v, 0.1, 1234, 256, with_lse=True)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    ref = flash_self_attention_reference(qg, kg, vg, 0.1, 1234, 256)
    sdpa = F.scaled_dot_product_attention(qg, kg, vg)
    elt = q.element_size()
    records = []
    for name, flops, nbytes, fns in (
            ("flash_self_attention_fwd", 4.0 * bh * n * n * d,
             4.0 * bh * n * d * elt,
             {"ms": lambda: flash_self_attention(q, k, v, 0.1, sd, 256),
              "plain_ms": lambda: flash_self_attention_reference(
                  q, k, v, 0.1, 1234, 256),
              "library_ms": lambda: F.scaled_dot_product_attention(q, k, v)}),
            ("flash_self_attention_bwd", 10.0 * bh * n * n * d,
             8.0 * bh * n * d * elt + 4.0 * bh * n,
             {"ms": lambda: flash_self_attention_backward(
                 q, k, v, out, g, lse, 0.1, 1234, 256),
              "plain_ms": lambda: torch.autograd.grad(
                  ref, (qg, kg, vg), g, retain_graph=True),
              "library_ms": lambda: torch.autograd.grad(
                  sdpa, (qg, kg, vg), g, retain_graph=True)})):
        times = {key: cuda_ms(fn) for key, fn in fns.items()}
        bound_ms, bound_by = bound(flops, nbytes, PEAK_FLOPS["bfloat16"])
        kind = "fwd" if name.endswith("fwd") else "bwd"
        records.append({
            "name": name, "route": "cuda",
            "source": "manigaussian_tpu_torch/csrc/flash_attention.cu",
            "replaces": ("manigaussian_tpu/ops/flash_attention.py:138" if kind == "fwd"
                         else "manigaussian_tpu/ops/flash_attention.py:166"),
            "launches": None, "max_abs_err": errs[kind], **times,
            "bound_ms": bound_ms, "bound_by": bound_by})
        log("kernel_time", kernel=name, shape=[1, 8, n, d], dtype="bfloat16",
            dropout=0.1, flops=flops, bytes=nbytes, **times, bound_ms=bound_ms,
            bound_by=bound_by, tflops=flops / times["ms"] / 1e9)
    return {r["name"]: r for r in records}


def random_frame(n: int = 16384, hw: int = 128, seed: int = 0):
    """A real frame's blend inputs: n random Gaussians (the JAX tests'
    random_scene distribution, drawn with numpy) in front of a 128² camera,
    binned and packed by the port's rasterizer on the card."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.ops import gaussian_math as gm
    from manigaussian_tpu_torch.ops.camera import novel_camera_calib
    from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                       pack_tiles, tile_lists)
    rng = np.random.default_rng(seed)
    f = np.float32
    means = np.array([0.0, 0.0, 2.0]) + 0.5 * rng.standard_normal((n, 3))
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 3)))
    q = rng.standard_normal((n, 4))
    rots = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, n)
    shs = 0.3 * rng.standard_normal((n, 4, 3))
    lang = rng.standard_normal((n, 3))
    t = lambda x: torch.tensor(np.asarray(x, f), device="cuda")[None]
    intr = torch.tensor([[hw * 0.95, 0, hw / 2], [0, hw * 0.95, hw / 2], [0, 0, 1]],
                        device="cuda")
    cam = novel_camera_calib(intr[None], torch.eye(4, device="cuda")[None],
                             0.1, 4.0, hw, hw)
    cfg = RasterizeConfig(width=hw, height=hw)
    pre = gm.preprocess(t(means), t(opac), cam, hw, hw, 16, scales=t(scales),
                        rotations=t(rots), shs=t(shs))
    gidx, in_list, _, ov_s, ov_g = tile_lists(pre, cfg)
    with torch.no_grad():
        counts, origins, attrs, livet = pack_tiles(pre, t(lang), gidx, in_list,
                                                   cfg, 1)
    return counts, origins, attrs, livet, cfg, int(ov_s), int(ov_g)


def phase_blend() -> dict:
    """The blend forward and backward against the plain version on a real
    frame's tiles (and ragged capacities); the golden frames; the times."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.ops.blend import (blend_backward, blend_forward,
                                                  blend_tiles,
                                                  blend_tiles_reference)

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for seed, hw, cap in ((0, 128, 2048), (1, 128, 512), (2, 64, 256)):
        counts, origins, attrs, livet, cfg, ov_s, ov_g = random_frame(
            16384 if hw == 128 else 2048, hw, seed)
        if cap != attrs.shape[2]:   # a smaller capacity: the front-most splats
            attrs = attrs[:, :, :cap].contiguous()
            livet = livet[:, :, :cap].contiguous()
        chunk = min(256, cap)
        t = attrs.shape[0]
        gs = [torch.randn(t, c, 256, generator=gen, device="cuda")
              for c in (3, 3, 1)]
        a1 = attrs.clone().requires_grad_()
        out = blend_tiles(counts, origins, a1, livet, 3, 16, chunk)
        sum((o * g).sum() for o, g in zip(out, gs)).backward()
        a2 = attrs.clone().requires_grad_()
        ref = blend_tiles_reference(counts, origins, a2, livet, 3, 16, chunk)
        sum((o * g).sum() for o, g in zip(ref, gs)).backward()
        torch.cuda.synchronize()
        fwd = [mostly_close(o.detach().cpu(), r.detach().cpu(), 1e-4, 1e-3)
               for o, r in zip(out, ref)]
        bwd = mostly_close(a1.grad.cpu(), a2.grad.cpu(), 2e-4, 1e-3, 0.02)
        ok = all(x[0] for x in fwd) and bwd[0]
        log("kernel_check", kernel="blend_tiles", tiles=t, capacity=cap,
            chunk=chunk, gaussians=16384 if hw == 128 else 2048, image=hw,
            splats_binned=int(counts.sum()), overflow_splats=ov_s,
            overflow_gaussians=ov_g,
            fwd_frac_outside_max_diff=[x[1:] for x in fwd],
            bwd_frac_outside_max_diff=bwd[1:],
            rule="outputs atol 1e-4 rtol 1e-3 ≤0.5 % outside; dattrs atol "
                 "2e-4 rtol 1e-3 ≤2 % outside (the JAX golden tests' rules)",
            ok=ok)
        if not ok:
            raise AssertionError(f"blend kernels disagree (seed {seed}): "
                                 f"fwd {fwd} bwd {bwd}")
        if seed == 0:
            errs = {"fwd": max(x[2] for x in fwd), "bwd": bwd[2]}
            main = (counts, origins, attrs, livet, gs, chunk)
    phase_golden()

    counts, origins, attrs, livet, gs, chunk = main
    t, c, k = attrs.shape
    color, lang, logtf = blend_forward(counts, origins, attrs, livet, 3, 16, chunk)
    n_end = torch.clamp((counts[:, 0] + chunk - 1) // chunk * chunk, max=k)
    pairs = float(n_end.sum()) * 256
    records = {}
    for kind in ("fwd", "bwd"):
        if kind == "fwd":
            fns = {"ms": lambda: blend_forward(counts, origins, attrs, livet, 3, 16, chunk),
                   "plain_ms": lambda: blend_tiles_reference(
                       counts, origins, attrs, livet, 3, 16, chunk)}
            nbytes = 4.0 * (attrs.numel() + livet.numel() + 3 * t) \
                + 4.0 * t * 256 * 7
        else:
            ar = attrs.clone().requires_grad_()
            rout = blend_tiles_reference(counts, origins, ar, livet, 3, 16, chunk)
            fns = {"ms": lambda: blend_backward(counts, origins, attrs, livet,
                                                *gs, 3, 16, chunk),
                   "plain_ms": lambda: torch.autograd.grad(
                       rout, ar, gs, retain_graph=True)}
            nbytes = 4.0 * (2 * attrs.numel() + livet.numel() + 3 * t) \
                + 4.0 * t * 256 * 7
        times = {key: cuda_ms(fn, iters=10) for key, fn in fns.items()}
        t_sfu = pairs * BLEND_SFU[kind] / PEAK_SFU
        t_fp = pairs * BLEND_FLOPS[kind] / PEAK_FLOPS["float32"]
        t_bytes = nbytes / PEAK_BYTES
        bound_ms = max(t_sfu, t_fp, t_bytes) * 1e3
        bound_by = "bytes" if t_bytes >= max(t_sfu, t_fp) else "operations"
        name = f"blend_{kind}"
        records[name] = {
            "name": name, "route": "cuda",
            "source": "manigaussian_tpu_torch/csrc/blend.cu",
            "replaces": ("manigaussian_tpu/ops/pallas_blend.py:317" if kind == "fwd"
                         else "manigaussian_tpu/ops/pallas_blend.py:339"),
            "launches": None, "max_abs_err": errs[kind], **times,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        log("kernel_time", kernel=name, tiles=t, capacity=k, chunk=chunk,
            splat_pixel_pairs=pairs, bytes=nbytes, **times, bound_ms=bound_ms,
            bound_by=bound_by, bound_parts_ms={"sfu": t_sfu * 1e3,
                                               "fp32": t_fp * 1e3,
                                               "bytes": t_bytes * 1e3},
            library_ms=None)
    return records


def phase_golden() -> None:
    """tests/goldens/tabletop_{dense,sparse}.npz (frames the JAX package
    pinned from its oracle) rendered on the card through the kernel route:
    color, language and final-T frames under the golden tests' rule, radii
    exact. The pinned gradients belong to a loss whose weights come from
    jax.random, so the card's backward is held to the plain route above."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.ops.blend import blend_forward
    from manigaussian_tpu_torch.ops.camera import novel_camera_calib
    from manigaussian_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize

    for name in ("tabletop_dense", "tabletop_sparse"):
        d = dict(np.load(os.path.join(ROOT, "tests", "goldens", name + ".npz")))
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
        res = {k: mostly_close(getattr(out, f).cpu(), d[g], 1e-4, 1e-3)
               for k, f, g in (("color", "color", "golden_color"),
                               ("lang", "language_feature", "golden_lang"),
                               ("final_t", "final_t", "golden_final_t"))}
        radii_ok = bool(np.array_equal(out.radii.cpu().numpy(), d["golden_radii"]))
        ok = (all(r[0] for r in res.values()) and radii_ok
              and blend_forward.launches == before + 1
              and int(extras.overflow_splats) == 0
              and int(extras.overflow_gaussians) == 0)
        log("golden", fixture=name, image=[h, w], gaussians=n,
            frac_outside_max_diff={k: r[1:] for k, r in res.items()},
            radii_equal=radii_ok, rule="atol 1e-4 rtol 1e-3, ≤0.5 % outside",
            ok=ok)
        if not ok:
            raise AssertionError(f"golden frame {name} disagrees: {res}")


def phase_conv_yardsticks() -> None:
    """Rows 5-6 of the kernel table (the Pallas 3³ conv and its weight
    gradient, not on the w_geo path): F.conv3d and its weight gradient at
    the 100³ tail convs' shapes in bf16, beside their bounds."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, ci, co in (("final 256→128", 256, 128), ("up0 post 128→128", 128, 128)):
        x = torch.randn(1, ci, 100, 100, 100, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        wt = (0.05 * torch.randn(co, ci, 3, 3, 3, generator=gen, device="cuda")).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        gy = torch.randn(1, co, 100, 100, 100, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        flops = 2.0 * 100 ** 3 * 27 * ci * co
        fwd_ms = cuda_ms(lambda: F.conv3d(x, wt, padding=1), iters=10)
        dw_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(x, wt.shape, gy,
                                                            padding=1), iters=10)
        b_fwd = bound(flops, 2.0 * (x.numel() + wt.numel() + gy.numel()),
                      PEAK_FLOPS["bfloat16"])
        b_dw = bound(flops, 2.0 * (x.numel() + gy.numel() + wt.numel()),
                     PEAK_FLOPS["bfloat16"])
        log("conv_yardstick", conv=label, shape=[1, 100, 100, 100, ci],
            dtype="bfloat16", library_conv3d_ms=fwd_ms, bound_ms=b_fwd[0],
            bound_by=b_fwd[1], library_conv3d_weight_ms=dw_ms,
            weight_bound_ms=b_dw[0], weight_bound_by=b_dw[1])


def phase_small() -> None:
    import torch
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.ops.flash_attention import flash_self_attention
    from manigaussian_tpu_torch.ops.voxelize import voxelize

    # voxelize: points on cell boundaries and out of bounds land in the same
    # cells on the card as on the CPU, and two runs on the card are equal bit
    # for bit (the scatter is a sorted segment sum, not atomics)
    gen = torch.Generator().manual_seed(1)
    bounds = torch.tensor([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6])
    res = (bounds[3:] - bounds[:3]) / 100
    pts = torch.cat([bounds[:3] + torch.randint(0, 101, (4096, 3), generator=gen) * res,
                     bounds[:3] + (torch.rand(4096, 3, generator=gen) * 1.4 - 0.2)
                     * (bounds[3:] - bounds[:3])])[None]
    feats = torch.rand(1, 8192, 3, generator=gen) * 2 - 1
    vc = voxelize(pts, feats, bounds, 100)
    vg = [voxelize(pts.cuda(), feats.cuda(), bounds.cuda(), 100).cpu()
          for _ in range(2)]
    vox_ok = (torch.equal(vg[0], vg[1]) and torch.equal(vg[0][..., -1], vc[..., -1])
              and (vg[0] - vc).abs().max().item() <= 1e-6)
    log("voxelize_reference", points=8192, voxel=100,
        same_occupancy=torch.equal(vg[0][..., -1], vc[..., -1]),
        deterministic=torch.equal(vg[0], vg[1]),
        max_abs_err=(vg[0] - vc).abs().max().item(), tol=1e-6, ok=vox_ok)
    if not vox_ok:
        raise AssertionError("voxelize on the card disagrees with the CPU")

    obs = {
        "rgb": torch.rand(1, 1, 16, 16, 3, generator=gen),
        "pcd": torch.tensor([0.2, 0.0, 1.1]) + 0.05 * torch.randn(
            1, 1, 16, 16, 3, generator=gen),
        "low_dim_state": torch.zeros(1, 4),
        "lang_goal_emb": 0.1 * torch.randn(1, 1024, generator=gen),
        "lang_token_embs": 0.1 * torch.randn(1, 77, 512, generator=gen),
    }
    micro = C.micro_variant("w_geo", camera_resolution=(16, 16))
    # (dtype, pad mode, conv impl): the default micro config, the reference's
    # edge padding, and edge padding in bf16 (compared by the route rule;
    # head dim 16, as the bf16 kernel takes multiples of 16)
    for dtype, pad, conv in (("float32", "zero", "z2d"), ("float32", "edge", "xla"),
                             ("bfloat16", "edge", "xla")):
        cfg = dataclasses.replace(micro, method=dataclasses.replace(
            micro.method, policy_dtype=dtype, policy_pad_mode=pad,
            policy_conv_impl=conv,
            latent_dim_head=(16 if dtype == "bfloat16"
                             else micro.method.latent_dim_head)))
        gpu = ManiGaussianBCAgent(cfg, device="cuda", seed=0)
        cpu = ManiGaussianBCAgent(cfg, device="cpu", seed=0)
        before = flash_self_attention.launches
        qg, qc = gpu.q_values(obs), cpu.q_values(obs)
        ag, ac = gpu.act(obs), cpu.act(obs)
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for name in ("q_trans", "q_rot_grip", "q_collision"):
            ref = getattr(qc, name).float()
            errs[name] = (getattr(qg, name).cpu().float() - ref).abs().max().item()
            tols[name] = (1e-3 if dtype == "float32"
                          else ROUTE_TOL * max(1.0, ref.abs().max().item()))
        same = all(torch.equal(getattr(ag, f).cpu(), getattr(ac, f)) for f in
                   ("trans_coords", "rot_grip_indices", "collision_indices"))
        ok = (all(errs[n] <= tols[n] for n in errs)
              and (same or dtype != "float32")
              and flash_self_attention.launches > before)
        log("small_reference", config=f"micro_variant(w_geo) {dtype} pad={pad} "
            f"conv={conv}, 16x16", max_abs_err=errs, tol=tols,
            same_discrete_action=same, ok=ok)
        if not ok:
            raise AssertionError(f"card and CPU disagree on the small input: {errs}")


def phase_slice(counters: dict) -> dict:
    import torch
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch import eval as eval_cli
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.utils.checkpoint import save_checkpoint

    task = "open_drawer"
    base = C.w_geo()
    cfg = dataclasses.replace(base, rlbench=dataclasses.replace(
        base.rlbench, tasks=(task,)))
    m = cfg.method
    demos, logdir = os.path.join(WORK, "demos"), os.path.join(WORK, "logs")
    t0 = time.time()
    generate_task(demos, task, num_episodes=2, timesteps=16,
                  h=cfg.rlbench.camera_resolution[0],
                  w=cfg.rlbench.camera_resolution[1], nerf_views=1, nerf_hw=8)
    agent = create_agent(cfg, device="cuda", seed=0)
    save_checkpoint(logdir, 0, agent.qfn, cfg=cfg)
    n_params = sum(p.numel() for p in agent.qfn.parameters())
    del agent
    setup_s = time.time() - t0

    calls, shapes, finite = [0], [], []
    orig_act = ManiGaussianBCAgent.act

    def counted_act(self, observation):
        res = orig_act(self, observation)
        calls[0] += 1
        shapes.append(list(res.continuous_action.shape))
        finite.append(bool(torch.isfinite(res.continuous_action).all()))
        return res

    ManiGaussianBCAgent.act = counted_act
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.time()
        rows = eval_cli.main(["--logdir", logdir, "--demo-root", demos,
                              "--env", "mock", "--eval-type", "last",
                              "--episodes", "2", "--episode-length", "5"])
        torch.cuda.synchronize()
        eval_s = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        ManiGaussianBCAgent.act = orig_act

    expected = m.transformer_depth * calls[0]
    ok = (calls[0] >= 2 and all(s == [1, 9] for s in shapes) and all(finite)
          and launches["flash_self_attention_fwd"] == expected
          and all(v == 0 for k, v in launches.items()
                  if k != "flash_self_attention_fwd")
          and len(rows) == 1 and "eval_envs/return" in rows[0])
    log("slice", config="w_geo", voxel=m.voxel_sizes[0],
        latents=[m.num_latents, m.latent_dim], depth=m.transformer_depth,
        heads=[m.latent_heads, m.latent_dim_head], dtype=m.policy_dtype,
        camera=list(cfg.rlbench.camera_resolution), params=n_params,
        act_calls=calls[0], launches=launches, expected_flash=expected,
        rows=rows, setup_s=setup_s, eval_s=eval_s, ok=ok)
    if not ok:
        raise AssertionError("the act/eval slice failed its checks")
    return {"cfg": cfg, "logdir": logdir, "demos": demos, "launches": launches}


def phase_routes(cfg, logdir: str, demos: str) -> None:
    import torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.utils.checkpoint import restore_checkpoint

    agents = {}
    for impl in ("flash", "xla"):
        c = dataclasses.replace(cfg, method=dataclasses.replace(
            cfg.method, policy_attn_impl=impl))
        agents[impl] = create_agent(c, device="cuda", seed=0)
        restore_checkpoint(logdir, agents[impl].qfn)
    env = MockEnvClient(demos, cameras=cfg.rlbench.cameras)
    env.set_task(cfg.rlbench.tasks[0])
    o = env.reset_to_demo(0)
    sent, toks = create_language_model("stub").encode(
        cfg.rlbench.tasks[0].replace("_", " "))
    obs = {"rgb": o.rgb[None], "pcd": o.pcd[None],
           "low_dim_state": o.low_dim_state[None],
           "lang_goal_emb": sent[None], "lang_token_embs": toks[None]}

    q = {impl: a.q_values(obs) for impl, a in agents.items()}
    torch.cuda.synchronize()
    errs, scale, finite = {}, {}, True
    for name in ("q_trans", "q_rot_grip", "q_collision"):
        a, b = getattr(q["flash"], name).float(), getattr(q["xla"], name).float()
        finite &= bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        errs[name] = (a - b).abs().max().item()
        scale[name] = b.abs().max().item()
    ok = finite and all(errs[n] <= ROUTE_TOL * max(1.0, scale[n]) for n in errs)

    def act_once(agent):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.act(obs).continuous_action.cpu()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        for a in agents.values():
            act_once(a)
    lat = {impl: [] for impl in agents}
    for _ in range(12):
        for impl, a in agents.items():
            lat[impl].append(act_once(a))
    peak = {}
    for impl, a in agents.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a.act(obs).continuous_action.cpu()
        peak[impl] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                      "peak_above_weights_bytes":
                          torch.cuda.max_memory_allocated() - base}
    log("routes", max_abs_diff=errs, ref_scale=scale, tol=ROUTE_TOL,
        tol_rule="max|flash-xla| <= tol * max(1, max|xla|)", finite=finite,
        act_ms_median={k: statistics.median(v) for k, v in lat.items()},
        act_ms=lat, memory=peak, ok=ok)
    if not ok:
        raise AssertionError(f"kernel route and plain route disagree: {errs}")
    phase_profile(lambda: agents["flash"].act(obs).continuous_action.cpu(),
                  "act on w_geo")


def phase_profile(step, label: str, calls: int = 3) -> dict:
    """Where one call's time goes: torch.profiler over `calls` calls of
    `step` (which ends in a device→host copy) — wall time, summed kernel
    time (the device's busy share, one stream), the kernels and the aten ops
    with the most device time, all per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = prof.key_averages()
    # named ranges (agents/bc_agent.update) show on the device timeline as
    # annotation events spanning their kernels: they are not kernels
    named = lambda key: key.startswith("update/")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not named(e.key)),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    # device time of the kernels that start inside each range's device span;
    # autograd launches the backward's kernels from its own thread, outside
    # the "update/backward" range, so the backward's share is the rest
    flat = prof.events()
    spans = [e for e in flat if named(e.name) and e.device_type == DeviceType.CUDA]
    kern = [e.time_range for e in flat
            if e.device_type == DeviceType.CUDA and not named(e.name)]
    ranges = {}
    for e in spans:
        inside = sum(k.elapsed_us() for k in kern
                     if e.time_range.start <= k.start < e.time_range.end)
        ranges[e.name] = ranges.get(e.name, 0.0) + inside / 1e3 / calls
    if ranges:
        ranges["update/backward (the rest)"] = device_ms - sum(ranges.values())

    def rows(evs, attr, n=14):
        return [[e.key[:90], round(getattr(e, attr) / 1e3 / calls, 4),
                 e.count / calls] for e in evs[:n]]

    out = dict(route="kernel", label=label, calls=calls, wall_ms_per_call=wall_ms,
               kernel_ms_per_call=device_ms, range_kernel_ms_per_call=ranges,
               device_busy_share=device_ms / wall_ms if wall_ms else None,
               kernels_launched_per_call=sum(e.count for e in kernels) / calls,
               top_kernels_ms_count=rows(kernels, "self_device_time_total"),
               top_aten_ops_device_ms_count=rows(ops, "device_time_total"))
    log("profile", **out)
    return out


def micro_train_batch(b: int = 2, hw: int = 32, seed: int = 0) -> dict:
    """A micro-config training batch (numpy, from a seed): points spread over
    the view so that no tile overflows the micro capacity."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1.0]], f)
    return {
        "rgb": rng.uniform(size=(b, 1, hw, hw, 3)).astype(f),
        "pcd": (np.array([0.1, 0.0, 1.1]) + np.array([0.3, 0.3, 0.05])
                * rng.standard_normal((b, 1, hw, hw, 3))).astype(f),
        "low_dim_state": np.zeros((b, 4), f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": np.array([[10, 9, 11]] * b, np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]] * b, np.int32),
        "ignore_collisions": np.ones((b, 1), np.int32),
        "gripper_pose": np.tile(np.array([0.2, 0, 1.1, 0, 0, 0, 1.0], f), (b, 1)),
        "action": np.zeros((b, 8), f),
        "nerf_target_rgb": rng.uniform(size=(b, hw, hw, 3)).astype(f),
        "nerf_target_pose": np.tile(np.eye(4, dtype=f), (b, 1, 1)),
        "nerf_target_intrinsic": np.tile(intr, (b, 1, 1)),
    }


def phase_small_train(counters: dict) -> None:
    """The micro w_geo config's `update`, card against CPU: fp32, dropout
    rates 0, the same augmentation draws. Losses within 1e-4·max(1, |loss|),
    every parameter gradient within 1e-3·max|g| of its leaf plus 1e-5 (the
    floor covers a leaf whose exact gradient is zero, such as the trans
    decoder's bias: the gradient of a bias shared by all logits of a softmax
    is Σp − 1, rounding noise on both devices), and every flash and blend
    counter advanced."""
    import torch
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.ops.augmentation import sample_se3_draws

    cfg = C.micro_variant("w_geo")
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, input_dropout=0.0, attn_dropout=0.0))
    batch = micro_train_batch()
    draws = sample_se3_draws(torch.Generator().manual_seed(3), 2,
                             cfg.method.aug_rpy, cfg.method.rotation_resolution)
    agents = {dev: ManiGaussianBCAgent(cfg, device=dev, seed=0)
              for dev in ("cuda", "cpu")}
    before = {k: fn.launches for k, fn in counters.items()}
    metrics = {dev: {k: float(v) for k, v in a.update(
        batch, torch.Generator().manual_seed(0), draws=draws).items()}
        for dev, a in agents.items()}
    torch.cuda.synchronize()
    advanced = {k: fn.launches - before[k] for k, fn in counters.items()}
    loss_err = {k: abs(metrics["cuda"][k] - v) / max(1.0, abs(v))
                for k, v in metrics["cpu"].items()}
    grad_err = {}
    for (name, pg), pc in zip(agents["cuda"].qfn.named_parameters(),
                              agents["cpu"].qfn.parameters()):
        ref = pc.grad if pc.grad is not None else torch.zeros_like(pc)
        got = pg.grad.cpu() if pg.grad is not None else torch.zeros_like(pc)
        grad_err[name] = ((got - ref).abs().max().item()
                          / (1e-3 * ref.abs().max().item() + 1e-5))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    ok = (all(e <= 1e-4 for e in loss_err.values())
          and all(e <= 1.0 for e in grad_err.values())
          and all(v > 0 for v in advanced.values()))
    log("small_train", config="micro_variant(w_geo) fp32, dropout 0, batch 2",
        losses_cuda=metrics["cuda"], loss_rel_err=loss_err,
        worst_grad_err_over_tol=worst, launches=advanced,
        tol={"loss": "1e-4·max(1,|loss|)",
             "grad": "1e-3·max|g| per leaf + 1e-5"},
        ok=ok)
    if not ok:
        raise AssertionError(f"the micro update disagrees between card and CPU: "
                             f"{loss_err} {worst} {advanced}")


def w_geo_train_config(task: str):
    """The full-width w_geo config for the training phases: one task, two
    synthetic demos, in-memory replay, logs and checkpoints every step."""
    from manigaussian_tpu_torch import config as C
    base = C.w_geo()
    return [f"rlbench.tasks=[{task}]", "rlbench.demos=2",
            "replay.use_disk=false", "framework.log_freq=1",
            "framework.save_freq=1000", "framework.num_weights_to_keep=2"], base


def phase_train_slice(counters: dict, steps: int = 8) -> dict:
    """The training path at full w_geo width through the port's train entry
    point (main()), then a resume from its checkpoint. The counts are set to
    0 just before the first run and read just after."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints

    task = "open_drawer"
    overrides, cfg = w_geo_train_config(task)
    m = cfg.method
    demos = os.path.join(WORK, "train_demos")
    logdir = os.path.join(WORK, "train_logs")
    t0 = time.time()
    generate_task(demos, task, num_episodes=2, timesteps=16,
                  h=cfg.rlbench.camera_resolution[0],
                  w=cfg.rlbench.camera_resolution[1], nerf_views=3,
                  nerf_hw=m.neural_renderer.image_height)
    setup_s = time.time() - t0

    per_step, step_ms, metrics_seen = [], [], []
    orig_update = ManiGaussianBCAgent.update

    def counted_update(self, batch, generator, draws=None):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = orig_update(self, batch, generator, draws)
        float(out["total_loss"])                 # device→host copy
        step_ms.append((time.perf_counter() - t_start) * 1e3)
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
        metrics_seen.append({k: float(v) for k, v in out.items()})
        return out

    ManiGaussianBCAgent.update = counted_update
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        train_cli.main(["--demo-root", demos, "--logdir", logdir,
                        *overrides, f"framework.training_iterations={steps}"])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ckpts = list_checkpoints(os.path.join(logdir, "seed0"))
        n_first = len(per_step)
        train_cli.main(["--demo-root", demos, "--logdir", logdir, *overrides,
                        f"framework.training_iterations={steps + 1}",
                        "framework.load_existing_weights=true"])
        torch.cuda.synchronize()
    finally:
        ManiGaussianBCAgent.update = orig_update

    expect = {"flash_self_attention_fwd": m.transformer_depth,
              "flash_self_attention_bwd": m.transformer_depth,
              "blend_fwd": 1, "blend_bwd": 1}
    finite = all(np.isfinite(v) for row in metrics_seen for v in row.values())
    heads = ("total_loss", "bc_loss", "trans_loss", "rot_loss", "grip_loss",
             "collision_loss", "rgb_loss", "psnr", "overflow_splats",
             "overflow_gaussians")
    ok = (n_first == steps and len(per_step) == steps + 2 and finite
          and all(row == expect for row in per_step)
          and all(h in metrics_seen[0] for h in heads)
          and ckpts == [steps - 1]
          and sum(launches.values()) == steps * sum(expect.values()))
    warm = step_ms[2:n_first]
    log("train_slice", config="w_geo", voxel=m.voxel_sizes[0],
        latents=[m.num_latents, m.latent_dim], depth=m.transformer_depth,
        heads=[m.latent_heads, m.latent_dim_head], dtype=m.policy_dtype,
        image=[m.neural_renderer.image_height, m.neural_renderer.image_width],
        gaussians=int(np.prod(cfg.rlbench.camera_resolution)),
        dropout=[m.input_dropout, m.attn_dropout], batch=cfg.replay.batch_size,
        steps=steps, resumed_steps=len(per_step) - n_first, checkpoints=ckpts,
        launches=launches, launches_per_step=per_step, expected_per_step=expect,
        losses_first=metrics_seen[0], losses_last=metrics_seen[n_first - 1],
        overflow_per_step=[[r["overflow_splats"], r["overflow_gaussians"]]
                           for r in metrics_seen],
        step_ms=step_ms, step_ms_median_after_2=statistics.median(warm),
        peak_device_bytes=peak, setup_s=setup_s, train_s=train_s, ok=ok)
    if not ok:
        raise AssertionError("the training slice failed its checks")
    return {"launches": launches, "step_ms": statistics.median(warm),
            "demos": demos}


def phase_train_routes(demos: str) -> None:
    """One batch from the same weights through the kernel route (flash +
    pallas) and the plain route (xla + xla), dropout 0, the same draws:
    loss within 5e-2·max(1, |loss|), global gradient norm within 5e-2
    relative; the step time of each route (alternating); then
    torch.profiler over 2 training steps of the kernel route."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import assemble_batch, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.ops.augmentation import sample_se3_draws

    task = "open_drawer"
    _, cfg = w_geo_train_config(task)
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, input_dropout=0.0, attn_dropout=0.0))
    replay = TaskUniformReplay()
    fill_replay(replay, demos, task, 2, cfg.rlbench.cameras,
                cfg.rlbench.scene_bounds, cfg.method.voxel_sizes[0],
                cfg.method.rotation_resolution, cfg.rlbench.episode_length,
                create_language_model("stub"))
    rng = np.random.default_rng(0)
    batch = assemble_batch(replay.sample(1, rng), rng, cfg.method.num_view_for_nerf)
    draws = sample_se3_draws(torch.Generator().manual_seed(5), 1,
                             cfg.method.aug_rpy, cfg.method.rotation_resolution)
    agents = {}
    for route, (attn, blend) in (("kernel", ("flash", "pallas")),
                                 ("plain", ("xla", "xla"))):
        m = dataclasses.replace(cfg.method, policy_attn_impl=attn,
                                neural_renderer=dataclasses.replace(
                                    cfg.method.neural_renderer, backend=blend))
        agents[route] = ManiGaussianBCAgent(dataclasses.replace(cfg, method=m),
                                            device="cuda", seed=0)
    loss, gnorm = {}, {}
    for route, a in agents.items():
        out = a.update(batch, torch.Generator().manual_seed(0), draws=draws)
        loss[route] = float(out["total_loss"])
        gnorm[route] = float(torch.sqrt(sum((p.grad.float() ** 2).sum()
                                            for p in a.qfn.parameters()
                                            if p.grad is not None)))
    loss_diff = abs(loss["kernel"] - loss["plain"])
    gnorm_rel = abs(gnorm["kernel"] - gnorm["plain"]) / gnorm["plain"]

    def step(a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(a.update(batch, torch.Generator().manual_seed(0),
                       draws=draws)["total_loss"])
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        for a in agents.values():
            step(a)
    lat = {r: [] for r in agents}
    for _ in range(5):
        for r, a in agents.items():
            lat[r].append(step(a))
    ok = (np.isfinite(loss["kernel"]) and np.isfinite(loss["plain"])
          and loss_diff <= ROUTE_TOL * max(1.0, abs(loss["plain"]))
          and gnorm_rel <= ROUTE_TOL)
    log("train_routes", loss=loss, loss_abs_diff=loss_diff, grad_norm=gnorm,
        grad_norm_rel_diff=gnorm_rel, tol=ROUTE_TOL,
        step_ms_median={r: statistics.median(v) for r, v in lat.items()},
        step_ms=lat, ok=ok)
    if not ok:
        raise AssertionError(f"kernel and plain training routes disagree: "
                             f"{loss} {gnorm}")
    kernel = agents["kernel"]
    del agents
    torch.cuda.empty_cache()
    phase_profile(lambda: float(kernel.update(
        batch, torch.Generator().manual_seed(0), draws=draws)["total_loss"]),
        "w_geo training step", calls=2)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        from manigaussian_tpu_torch.ops.blend import (blend_backward,
                                                      blend_forward)
        from manigaussian_tpu_torch.ops.flash_attention import (
            flash_self_attention, flash_self_attention_backward)
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    counters = {"flash_self_attention_fwd": flash_self_attention,
                "flash_self_attention_bwd": flash_self_attention_backward,
                "blend_fwd": blend_forward, "blend_bwd": blend_backward}

    t_start = time.time()
    phase_build()
    records = {**phase_flash(), **phase_blend()}
    phase_conv_yardsticks()
    phase_small()
    phase_small_train(counters)
    sl = phase_slice(counters)
    phase_routes(sl["cfg"], sl["logdir"], sl["demos"])
    tr = phase_train_slice(counters)
    phase_train_routes(tr["demos"])
    for name, rec in records.items():
        rec["launches"] = tr["launches"][name]
    log("done", seconds=round(time.time() - t_start, 3))

    print(json.dumps({"kernels": list(records.values())}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
