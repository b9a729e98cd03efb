"""Chip smoke test of the PyTorch/CUDA port (`manigaussian_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. build       — compile every CUDA source of the port with nvcc (sm_90a),
                   one process per source, and print ptxas's register report;
  2. kernels     — hold each kernel against its plain PyTorch version on the
                   card at the main paths' shapes and a few ragged ones: the
                   flash forward (without and with the LSE and dropout, the
                   same hashed mask; the keep bits it writes in training
                   equal to the plain ones bit for bit) and backward (dq, dk,
                   dv against autograd of the plain version, bitwise
                   repeatable; in bf16 with dropout from those bits), with
                   ptxas's registers and spill of its three wgmma kernels;
                   the tile blend forward and backward on the
                   tiles of real frames (16,384 random Gaussians in a 128²
                   view, binned by the port's rasterizer; batch 2; the micro
                   config's K 512 / chunk 32; empty tiles; 65,536
                   Gaussians at K 2048; the bench's own frame at K 8192 /
                   chunk 512), each bitwise repeatable; `golden`: the
                   JAX package's pinned frames (tests/goldens/*.npz, read with
                   numpy) rendered through the kernel route; `conv`: the 3³
                   conv forward, dx and dW (workspace and resident scheme, each
                   bitwise repeatable, and against each other) in fp32 and
                   bf16 at ragged shapes and at the policy's two 100³ convs,
                   with ptxas's registers and spill of the two wgmma kernels.
                   Then time each kernel (the flash forward without and with
                   dropout, SDPA beside each at the same dropout rate), its
                   plain version and the PyTorch call that computes the same
                   function (a yardstick only; the port never calls it); the
                   flash kernels, SDPA and the blend kernels on the device
                   reading (the summed durations of their device work under
                   torch.profiler), the host loop's events beside it;
                   `bench`: the port's bench twin (manigaussian_tpu_torch/
                   bench.py: 65,536 Gaussians, 128², K 8192, chunk 512, the
                   gradient of every input) on the kernel route: renders/s,
                   the overflow counts, one blend forward and backward a
                   render and nothing else, the blend pair's device time and
                   share of a render, the rasterizer's ranges (preprocess,
                   bin/sort, gather, blend, the backward), busy share, peak;
  3. small       — references on small inputs, the card against the CPU (the
                   plain versions, which tests/test_torch_*.py hold to the JAX
                   package): voxelize on cell boundaries, the micro config's
                   act in fp32 and bf16 on each conv route, and `small_train`:
                   the micro configs' `update` in fp32, dropout 0, the same
                   draws (`w_geo`; `w_geo_dyna` and `w_geo_sem_dyna` on the
                   conv kernels, the latter with one `gt_embed` for both);
                   `sem_check`: the SD VAE (ch 32, 64²) and its GT-embed
                   pipeline on the card against the CPU, then at SD v1 width
                   on a 512² image its device time, TFLOP/s and peak memory,
                   and the GT-embed function's wall time for one 128² view;
                   `gnf_small`: the GNFACTOR_BC micro update as
                   `small_train` (the NeRF's draws from one CPU generator);
                   `clip_check`: the CLIP RN50 text tower at its published
                   width from seeded random weights, card against CPU on
                   fixed token ids, and one encode's time;
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
                   synthetic demos at 128² with nerf views, batch 1, 6 steps,
                   a checkpoint, then a resume; the counts are set to 0 just
                   before and read just after: per step `transformer_depth`
                   flash forwards and backwards, 1 blend forward and 1 blend
                   backward; finite losses; step time and peak memory;
  7. train_routes — one batch from the same weights through the kernel route
                   (flash + pallas) and the plain route (xla + xla), dropout
                   0 and fixed draws: loss and gradient norm, the step time
                   of each route, and torch.profiler over 2 training steps;
  8. dyna slice  — the same entry point with `--variant w_geo_dyna`,
                   `method.policy_conv_impl=pallas` and the dynamic field's
                   warm-up gate at step 2, full width otherwise: per step 4
                   conv forward/dx launches and 2 dW launches on top of the
                   flash ones, 1 + 1 blend launches before the gate and 2 + 2
                   after it and after the resume; then `dyna_act`: the eval
                   entry point on that checkpoint (2 conv and
                   `transformer_depth` flash forwards per act);
  9. conv_routes — one `w_geo_dyna` batch (gate open) through
                   `policy_conv_impl="pallas"` and `"z2d"`: loss, gradient
                   norm, step time and act latency of each, and
                   torch.profiler over 2 training steps of the pallas route;
 10. sem_slice   — the full model, `--variant w_geo_sem_dyna`, as the dyna
                   slice and with `foundation_checkpoint=random-init`: the
                   SD VAE (not the stub) computes each batch's `gt_embed` in
                   the prefetch thread on a CUDA stream of its own; the same
                   launches a step, `embed_loss` finite and non-zero every
                   step, the wait in `next(batches)`, and the wall and CPU
                   time of each embedding call in the prefetch thread; then
                   `sem_act`;
 11. sem_routes  — one `w_geo_sem_dyna` batch (gate open, its `gt_embed`
                   from the SD VAE) through the kernel route (flash + pallas
                   blend + pallas conv) and the plain route (xla + xla +
                   z2d), as `train_routes`, and torch.profiler over 2
                   training steps of the kernel route;
 12. gnf_slice   — the GNFACTOR_BC baseline (`method.name=GNFACTOR_BC` on
                   `w_geo`: the NeRF renderer at 128², 512 rays, 64 / 32 /
                   16 samples, MLP 512 × 5) through the train entry point as
                   `train_slice`: per step the flash kernels only, no blend
                   and no conv; then `gnf_act` through the eval entry point;
 13. gnf_routes  — one GNFACTOR_BC batch through the flash and the plain
                   attention as `train_routes`, `render_for_vis` called
                   directly (its wall time, a finite 128² image), the
                   profile of 2 steps; `nerf_parts`: the NeRF's forward and
                   backward alone at that width, and its trilinear scatter.
Every training slice also holds the recon render at step 0
(`render_for_vis`: the policy's forward, and one blend forward with the
splat renderer) to its launches.
Then one JSON line of kernel records, the card's name and power limit, and
last, the device line.

`python3 chip_smoke.py --flash-times` builds the kernels and prints only the
flash kernels' times (`flash_times`, through the public entry point): run
from the root of two checkouts in turn, it times both with one yardstick.
`--blend-times` does the same for the tile blend pair (`blend_times`,
through `blend_tiles` and autograd). `--embed-ab` builds the kernels and
compares where the SD VAE's ground-truth embedding runs in `w_geo_sem_dyna`
training (`embed_ab`: its prefetch thread on a stream of its own or on the
default stream, the main thread, or no tower).

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
# 32-bit integer operations a second: 64 INT32 lanes a clock on each SM (16
# in each of its 4 partitions, same white paper) at the same clock
PEAK_INT32 = 132 * 64 * 1.98e9
# the attention dropout mask's integer work per score in its factored form
# (flash_attention.cu, `Dropout`): the xor of the row's and the column's
# mixed parts (each computed once per row or key, not counted), a multiply,
# a shift and a xor, a multiply, the xor with the folded threshold and the
# compare: five integer-pipe operations and two multiplies
DROPOUT_INT_OPS = 7
# The blend's work, counted from what the function needs on these inputs
# (`blend_work`). Special-function units: the active pairs (a > 0, before
# the pixel's latch) × one exp in the forward, one exp and one reciprocal in
# the backward. fp32 pipes: the boxed pairs — those inside their splat's
# conservative pixel box (ops/blend.py `splat_box`) and no later than their
# pixel's latch; a pair outside the box is skipped at a cost per splat, not
# per pair — × the fp32 instructions a pair needs, an FMA counting one:
# forward 15 (the power from the six coefficients with the x part shared:
# 2; alpha and its clamp 2; the two skip tests 2; T·(1 − a) 1; the latch
# test 1; the weight 1; 6 accumulators), backward 33 (the pair, T and the
# latch as in the forward: 8; the cotangent gcolor·rgb + glang·feat 6; the
# weight, the prefix and the suffix 4; dα 3; its gates 2; d(power) 1; three
# monomial sums, the x part shared, 3; d(opacity) 1; d(rgb) and d(features)
# 6). Per live slot below the walk end, for loading and boxing it: 90 fp32
# instructions (tile-local position 2; the six power coefficients 15 and
# their log2 e scaling 6; the box: the definiteness test 7, the rounding
# slack 15, τ 9, two half extents 22, the clamped bounds and the empty test
# 14) and 5 SFU operations (a log, two reciprocals, two square roots); the
# backward adds 60 fp32 for the warps' sums and the closed forms.
BLEND_SFU = {"fwd": 1, "bwd": 2}
BLEND_FP32 = {"fwd": 15, "bwd": 33}
BLEND_SLOT_SFU = {"fwd": 5, "bwd": 5}
BLEND_SLOT_FP32 = {"fwd": 90, "bwd": 150}
# fp32 instructions a second: 128 lanes a clock on each of the 132 SMs (32
# in each of its 4 partitions, Hopper white paper) at 1.98 GHz
PEAK_FP32_INSTR = 132 * 128 * 1.98e9
# The earlier count of the bound, kept beside this one so that factors
# compare across versions of the kernels: every slot up to the walk end ×
# 256 pixels, 2 / 4 SFU operations and 20 / 60 fp32 FLOPs (at 67 TFLOP/s)
# a pair, the bytes without the saved state
BLEND_OLD = {"fwd": (2, 20), "bwd": (4, 60)}

# The kernel route and the plain route differ only in where bf16 rounds
# inside attention (unnormalized vs normalized probabilities, summation
# order); through 6 residual layers, the decoder and the 100³ convs that
# stays a few bf16 steps (2^-8 relative each) of the Q-values' scale.
ROUTE_TOL = 5e-2

# the named ranges of the port (agents/bc_agent.update, ops/rasterizer):
# on the device timeline they are annotation events spanning their kernels,
# not kernels
RANGE_PREFIXES = ("update/", "rasterize/")


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
    """Host-loop reading: CUDA events around `iters` back-to-back calls. For
    a kernel of tens of microseconds it reads the host's enqueue rate as
    much as the kernel (`host_loop_ms` beside `device_ms`)."""
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


def device_ms(fn, iters: int = 20, warmup: int = 3, by_kernel=None) -> float:
    """Device reading: the summed durations of the device work (kernels and
    memsets) that `iters` calls of `fn` launch, from torch.profiler's CUDA
    trace, per call (the named ranges' annotation events left out). The host's enqueue rate and the gaps between launches do
    not show. `by_kernel`, a dict, receives the time per call of each kernel
    name. A profiler session started right after another one may come back
    without its device records; such a session is run again, up to twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        time.sleep(0.1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(RANGE_PREFIXES)]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            break
    else:
        raise AssertionError("torch.profiler saw no device time")
    if by_kernel is not None:
        by_kernel.update({e.key[:80]: e.self_device_time_total / 1e3 / iters
                          for e in events})
    return total_us / 1e3 / iters


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


# flash_attention.cu's bf16 wgmma kernels, held to no spill and no
# serialized wgmma (ptxas's C7512 or C7520) in phase `flash`
FLASH_WGMMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dkdv_bf16_kernel",
                       "flash_bwd_dq_bf16_kernel")


def flash_checks() -> dict:
    """The flash kernels against the plain version at every shape of the
    list, bf16 and fp32: the forward without the LSE (act's call) and with it
    (training's, through autograd), the backward against autograd of the
    plain version; in bf16 with dropout the keep bits the forward writes
    equal `dropout_keep_bits` bit for bit, and the backward reads them; dq,
    dk, dv bitwise equal over two backward calls. Returns the errors at the
    policy's training shape."""
    import torch
    from manigaussian_tpu_torch.ops.flash_attention import (
        dropout_keep_bits, flash_attention_forward, flash_self_attention,
        flash_self_attention_backward, flash_self_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (dtype, N, head dim, forward tolerance): bf16 at the policy's shape and
    # ragged ones, each at dropout 0 and 0.1; the backward's tolerance: bf16
    # 2e-2·max(1, max|ref|), fp32 1e-4·max(1, max|ref|) (sums over N keys in
    # another order)
    shapes = [("bfloat16", 2048, 64, 2e-2), ("bfloat16", 256, 64, 2e-2),
              ("bfloat16", 512, 32, 2e-2), ("bfloat16", 100, 16, 2e-2),
              ("bfloat16", 100, 64, 2e-2), ("float32", 2048, 64, 1e-5),
              ("float32", 512, 64, 1e-5), ("float32", 32, 8, 1e-5)]
    errs = {}
    for dtype, n, d, tol in shapes:
        for rate in (0.0, 0.1):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(1, 8, n, d, generator=gen, device="cuda").to(dt)
                       .requires_grad_() for _ in range(3))
            bq = 256 if n % 256 == 0 else n
            seed = 1234
            with torch.no_grad():   # act's call: no LSE, no bits
                out_nolse = flash_self_attention(q, k, v, rate, torch.tensor([seed]), bq)
            out = flash_self_attention(q, k, v, rate, torch.tensor([seed]), bq)
            g = torch.randn(out.shape, generator=gen, device="cuda")
            grads = torch.autograd.grad((out.float() * g).sum(), (q, k, v))
            ref = flash_self_attention_reference(q, k, v, rate, seed, bq)
            rgrads = torch.autograd.grad((ref.float() * g).sum(), (q, k, v))
            fwd_err = (out.float() - ref.float()).abs().max().item()
            nolse_err = (out_nolse.float() - ref.float()).abs().max().item()
            btol = 2e-2 if dtype == "bfloat16" else 1e-4
            bwd = {}
            for name, a, b in zip(("dq", "dk", "dv"), grads, rgrads):
                scale = max(1.0, b.float().abs().max().item())
                bwd[name] = (a.float() - b.float()).abs().max().item() / scale
            # the backward again, directly: bitwise repeatable
            qd, kd, vd = (x.detach() for x in (q, k, v))
            gd = g.to(dt)
            extra = {}
            o2, lse, bits = flash_attention_forward(qd, kd, vd, rate, seed, bq,
                                                    with_lse=True)
            runs = [flash_self_attention_backward(qd, kd, vd, o2, gd, lse, rate, seed, bq,
                                                  keep_bits=bits)
                    for _ in range(2)]
            extra["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(*runs))
            if bits is not None:
                extra["keep_bits_equal_plain"] = torch.equal(
                    bits, dropout_keep_bits(seed, rate, 8, n, bq, "cuda"))
            torch.cuda.synchronize()
            ok = (bool(torch.isfinite(out).all()) and fwd_err <= tol
                  and nolse_err <= tol and all(e <= btol for e in bwd.values())
                  and all(extra.values()))
            log("kernel_check", kernel="flash_self_attention", dtype=dtype,
                shape=[1, 8, n, d], dropout=rate, max_abs_err=fwd_err,
                max_abs_err_without_lse=nolse_err, tol=tol,
                bwd_err_over_scale=bwd, bwd_tol=btol, **extra, ok=ok)
            if not ok:
                raise AssertionError(f"flash kernels disagree: {dtype} n={n} d={d} "
                                     f"rate={rate} fwd={fwd_err} {nolse_err} "
                                     f"bwd={bwd} {extra}")
            if (dtype, n, d, rate) == ("bfloat16", 2048, 64, 0.1):
                errs = {"fwd": fwd_err, "bwd": max(bwd.values()) * max(
                    1.0, max(b.float().abs().max().item() for b in rgrads))}
    return errs


def flash_times() -> dict:
    """The flash kernels' times at the policy's shape, [1, 8, 2048, 64] bf16,
    on the device reading (`device_ms`) with the host loop's beside it,
    called as the policy calls them, through `flash_self_attention` and
    autograd: the forward without dropout (act's call, no gradient) and with
    dropout 0.1 on inputs that need the gradient (training's: the LSE and
    the keep bits), the backward at dropout 0.1; SDPA's forward and backward
    at the same dropout rate (a yardstick only) and the plain version, the
    same way."""
    import torch
    import torch.nn.functional as F
    from manigaussian_tpu_torch.ops.flash_attention import (
        flash_self_attention, flash_self_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 2048, 64
    q, k, v, g = (torch.randn(1, 8, n, d, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    sd = torch.tensor([1234])
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_self_attention(qg, kg, vg, 0.1, sd, 256)
    ref = flash_self_attention_reference(qg, kg, vg, 0.1, 1234, 256)
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=0.1)
    grad = lambda y: torch.autograd.grad(y, (qg, kg, vg), g, retain_graph=True)

    def both(fn, plain=False):
        """device_ms and host_loop_ms of `fn`, and its kernels' device times"""
        iters = 3 if plain else 20
        kernels = {}
        return {"device": device_ms(fn, iters=iters, warmup=1, by_kernel=kernels),
                "host_loop": cuda_ms(fn, iters=iters, warmup=1),
                **({} if plain else {"kernels": kernels})}

    with torch.no_grad():
        times = {
            "fwd_act": both(lambda: flash_self_attention(q, k, v, 0.0, sd, 256)),
            "sdpa_fwd_0": both(lambda: F.scaled_dot_product_attention(q, k, v)),
            "sdpa_fwd_0.1": both(lambda: F.scaled_dot_product_attention(
                q, k, v, dropout_p=0.1)),
            "plain_fwd_0": both(lambda: flash_self_attention_reference(
                q, k, v, 0.0, 1234, 256), plain=True),
            "plain_fwd_0.1": both(lambda: flash_self_attention_reference(
                q, k, v, 0.1, 1234, 256), plain=True),
        }
    times.update({
        "fwd_train": both(lambda: flash_self_attention(qg, kg, vg, 0.1, sd, 256)),
        "bwd": both(lambda: grad(out)),
        "sdpa_bwd_0.1": both(lambda: grad(sdpa)),
        "plain_bwd_0.1": both(lambda: grad(ref), plain=True),
    })
    log("flash_times", shape=[1, 8, n, d], dtype="bfloat16", ms=times)
    return times


def phase_flash() -> dict:
    """The flash forward (with and without dropout) and backward against the
    plain version; ptxas's registers and spill of the wgmma kernels; then
    their times at the policy's shape."""
    errs = flash_checks()
    build = {k: ptxas_report("flash_attention", k) for k in FLASH_WGMMA_KERNELS}
    log("kernel_build", source="manigaussian_tpu_torch/csrc/flash_attention.cu",
        **build)
    if any(b["spill_bytes"] or b["wgmma_serialized"] for b in build.values()):
        raise AssertionError(f"the wgmma flash kernels spill or serialize: {build}")

    from manigaussian_tpu_torch.ops.flash_attention import keep_bits_words

    times = flash_times()
    n, d, bh = 2048, 64, 8
    elt = 2
    fwd_flops, fwd_bytes = 4.0 * bh * n * n * d, 4.0 * bh * n * d * elt
    # the keep bits: training's forward writes them, the backward reads them
    bits_bytes = 4.0 * bh * n * keep_bits_words(n)
    int_ms = DROPOUT_INT_OPS * bh * n * n / PEAK_INT32 * 1e3
    source = "manigaussian_tpu_torch/csrc/flash_attention.cu"

    def variant(kind, lib, plain, bound_ms, bound_by, **extra):
        t = times[kind]
        rec = {"ms": t["device"], "host_loop_ms": t["host_loop"],
               "plain_ms": times[plain]["device"],
               "library_ms": times[lib]["device"],
               "library_host_loop_ms": times[lib]["host_loop"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "factor_vs_bound": t["device"] / bound_ms,
               "factor_vs_library": t["device"] / times[lib]["device"], **extra}
        return rec

    tensor_ms, by = bound(fwd_flops, fwd_bytes, PEAK_FLOPS["bfloat16"])
    act = variant("fwd_act", "sdpa_fwd_0", "plain_fwd_0", tensor_ms, by,
                  dropout=0.0, with_lse=False)
    train_ms, _ = bound(fwd_flops, fwd_bytes + bits_bytes, PEAK_FLOPS["bfloat16"])
    train = variant("fwd_train", "sdpa_fwd_0.1", "plain_fwd_0.1",
                    max(train_ms, int_ms), "operations", dropout=0.1,
                    with_lse=True, writes_keep_bits=True)
    for rec in (act, train):
        nbytes = fwd_bytes + (bits_bytes if rec["dropout"] else 0.0)
        log("kernel_time", kernel="flash_self_attention_fwd", shape=[1, 8, n, d],
            dtype="bfloat16", flops=fwd_flops, bytes=nbytes,
            mask_int_ops=DROPOUT_INT_OPS * bh * n * n if rec["dropout"] else 0,
            bound_parts_ms={"tensor": fwd_flops / PEAK_FLOPS["bfloat16"] * 1e3,
                            "bytes": nbytes / PEAK_BYTES * 1e3,
                            "int32": int_ms if rec["dropout"] else 0.0},
            tflops=fwd_flops / rec["ms"] / 1e9, **rec)
    # the record carries training's variant (dropout 0.1, as on the main
    # path) and act's variant beside it
    records = [{"name": "flash_self_attention_fwd", "route": "cuda",
                "source": source,
                "replaces": "manigaussian_tpu/ops/flash_attention.py:138",
                "launches": None, "max_abs_err": errs["fwd"], **train,
                "no_dropout": act}]

    bwd_flops = 10.0 * bh * n * n * d
    # q, k, v, out, dO in; dq, dk, dv out; the LSE and the keep bits in (the
    # backward hashes no mask)
    bwd_bytes = 8.0 * bh * n * d * elt + 4.0 * bh * n + bits_bytes
    bound_ms, bound_by = bound(bwd_flops, bwd_bytes, PEAK_FLOPS["bfloat16"])
    bwd = variant("bwd", "sdpa_bwd_0.1", "plain_bwd_0.1", bound_ms, bound_by,
                  dropout=0.1, reads_keep_bits=True)
    records.append({"name": "flash_self_attention_bwd", "route": "cuda",
                    "source": source,
                    "replaces": "manigaussian_tpu/ops/flash_attention.py:166",
                    "launches": None, "max_abs_err": errs["bwd"], **bwd})
    log("kernel_time", kernel="flash_self_attention_bwd", shape=[1, 8, n, d],
        dtype="bfloat16", flops=bwd_flops, bytes=bwd_bytes,
        tflops=bwd_flops / bwd["ms"] / 1e9, **bwd)
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


def blend_work(counts, origins, attrs, livet, chunk) -> dict:
    """What the blend of a frame's tiles needs: slot pairs up to each tile's
    walk end (the earlier count), live slots and pairs below it, boxed pairs
    (inside the splat's `splat_box`, no later than the pixel's latch) and
    active pairs (a > 0, before the pixel's latch), from the plain version's
    arithmetic (the power from the tile-local monomials, T the running
    product)."""
    import torch
    from manigaussian_tpu_torch.ops.blend import (ALPHA_MAX, ALPHA_MIN, T_EPS,
                                                  _pixel_monomials,
                                                  _splat_coeffs, splat_box)
    t, _, k = attrs.shape
    n_end = torch.clamp((counts[:, 0].clamp(min=0) + chunk - 1) // chunk * chunk,
                        max=k)
    live = ((torch.arange(k, device=attrs.device)[None] < n_end[:, None])
            & (livet[:, 0] > 0.5))
    mono = _pixel_monomials(16, attrs.device)
    px, py = (mono[None, :, c:c + 1] for c in (1, 2))          # [1, P, 1]
    active = boxed = 0
    for t0 in range(0, t, 16):
        sl = slice(t0, t0 + 16)
        a_t, o_t = attrs[sl], origins[sl]
        xm, ym = a_t[:, 0] - o_t[:, 0:1], a_t[:, 1] - o_t[:, 1:2]
        coeff = _splat_coeffs(xm, ym, a_t[:, 2], a_t[:, 3], a_t[:, 4])
        power = torch.matmul(mono, coeff)                       # [16, P, K]
        alpha = torch.clamp(a_t[:, 5:6] * torch.exp(torch.clamp(power, max=0.0)),
                            max=ALPHA_MAX)
        on = (power <= 0) & (alpha >= ALPHA_MIN) & live[sl, None, :]
        a = torch.where(on, alpha, torch.zeros_like(alpha))
        t_incl = torch.cumprod(1.0 - a, dim=2)
        active += int(((a > 0) & (t_incl >= T_EPS)).sum())
        t_excl = torch.cat([torch.ones_like(t_incl[:, :, :1]), t_incl[:, :, :-1]], 2)
        x0, x1, y0, y1 = (b[:, None, :] for b in splat_box(
            xm, ym, a_t[:, 2], a_t[:, 3], a_t[:, 4], a_t[:, 5]))
        inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        boxed += int((inside & live[sl, None, :] & (t_excl >= T_EPS)).sum())
    return {"slot_pairs": float(n_end.sum()) * 256,
            "live_slots": float(live.sum()),
            "live_pairs": float(live.sum()) * 256, "boxed_pairs": float(boxed),
            "active_pairs": float(active)}


def blend_bound(kind: str, work: dict, nbytes: float, old_bytes: float) -> dict:
    """The blend kernel's bound on `work`, its parts, and the earlier
    count's bound beside it (`BLEND_OLD`). `fp32_if_every_live_pair_ms`, a
    diagnostic outside the bound, is the fp32 term had every live pair below
    the walk end to be evaluated."""
    t_sfu = (work["active_pairs"] * BLEND_SFU[kind]
             + work["live_slots"] * BLEND_SLOT_SFU[kind]) / PEAK_SFU
    t_fp = (work["boxed_pairs"] * BLEND_FP32[kind]
            + work["live_slots"] * BLEND_SLOT_FP32[kind]) / PEAK_FP32_INSTR
    t_live = work["live_pairs"] * BLEND_FP32[kind] / PEAK_FP32_INSTR
    t_bytes = nbytes / PEAK_BYTES
    s_old, f_old = BLEND_OLD[kind]
    old = max(work["slot_pairs"] * s_old / PEAK_SFU,
              work["slot_pairs"] * f_old / PEAK_FLOPS["float32"],
              old_bytes / PEAK_BYTES)
    return {"bound_ms": max(t_sfu, t_fp, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= max(t_sfu, t_fp) else "operations",
            "bound_parts_ms": {"sfu": t_sfu * 1e3, "fp32": t_fp * 1e3,
                               "bytes": t_bytes * 1e3},
            "fp32_if_every_live_pair_ms": t_live * 1e3,
            "old_bound_ms": old * 1e3}


def bench_frame():
    """The bench's frame (`manigaussian_tpu_torch/bench.py`: its 65,536
    Gaussians from seed 0, its 128² camera and its RasterizeConfig, K 8192,
    chunk 512), binned and packed by the port's rasterizer on the card.
    Returns ((counts, origins, attrs, livet), chunk, overflow_splats)."""
    import torch
    from manigaussian_tpu_torch import bench
    from manigaussian_tpu_torch.ops import gaussian_math as gm
    from manigaussian_tpu_torch.ops.rasterizer import pack_tiles, tile_lists
    s = bench.make_scene(65536, torch.Generator().manual_seed(0), "cuda")
    cfg = bench.bench_config(128)
    cam = bench.make_camera(128, "cuda")
    cam = type(cam)(*(f[None] for f in cam))
    pre = gm.preprocess(s["means"][None], s["opacities"][None], cam, 128, 128,
                        16, scales=s["scales"][None],
                        rotations=s["rotations"][None], shs=s["shs"][None])
    gidx, in_list, _, ov_s, _ = tile_lists(pre, cfg)
    with torch.no_grad():
        frame = pack_tiles(pre, s["lang"][None], gidx, in_list, cfg, 1)
    return frame, cfg.chunk, int(ov_s)


def blend_cases():
    """The frames of the blend checks, each (name, (counts, origins, attrs,
    livet), chunk, gaussians): the training frame (16,384 random Gaussians
    at 128², K 2048); batch 2 (two such frames, T = 128); the micro config's
    K 512 / chunk 32 (the front-most 512 slots of a frame); a 64² frame of
    2,048 Gaussians at K 256 with two tiles emptied (count 0); the 65,536
    frame of the root bench's distributions at K 2048 (full lists and
    overflow); the bench's own frame at its K 8192 and chunk 512."""
    import torch
    f0 = random_frame(16384, 128, 0)[:4]
    f1 = random_frame(16384, 128, 3)[:4]
    micro = [x.contiguous() for x in random_frame(16384, 128, 1)[:4]]
    micro[2] = micro[2][:, :, :512].contiguous()
    micro[3] = micro[3][:, :, :512].contiguous()
    small = list(random_frame(2048, 64, 2)[:4])
    small[2], small[3] = (x[:, :, :256].contiguous() for x in small[2:])
    small[0] = small[0].clone()
    small[0][[0, 5]] = 0
    small[3] = small[3].clone()
    small[3][[0, 5]] = 0
    return [("train_16384", f0, 256, 16384),
            ("batch2_16384", tuple(torch.cat([a, b]) for a, b in zip(f0, f1)), 256,
             2 * 16384),
            ("micro_k512_chunk32", tuple(micro), 32, 16384),
            ("count0_64px_k256", tuple(small), 256, 2048),
            ("frame_65536", random_frame(65536, 128, 4)[:4], 256, 65536),
            ("bench_k8192_chunk512", bench_frame()[0], 512, 65536)]


def phase_blend() -> dict:
    """The blend forward and backward against the plain version (through
    `blend_tiles` and autograd) on every frame of `blend_cases`, each kernel
    bitwise repeatable; the backward with one output unused; the golden
    frames; then the times at the training and the 65,536 frame, on the
    device reading with the host loop's beside it."""
    import torch
    from manigaussian_tpu_torch.ops.blend import (KERNEL_SEGMENTS,
                                                  blend_backward, blend_forward,
                                                  blend_tiles,
                                                  blend_tiles_reference,
                                                  segment_bounds, walk_end)

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, frames = {}, {}
    rule = ("outputs atol 1e-4 rtol 1e-3 ≤0.5 % outside; dattrs atol 2e-4 "
            "rtol 1e-3 ≤2 % outside (the JAX golden tests' rules)")
    for name, (counts, origins, attrs, livet), chunk, n_gauss in blend_cases():
        t, _, k = attrs.shape
        gs = [torch.randn(t, c, 256, generator=gen, device="cuda") for c in (3, 3, 1)]
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
        runs = [blend_forward(counts, origins, attrs, livet, 3, 16, chunk)
                for _ in range(2)]
        fwd_rep = all(torch.equal(x, y) for x, y in zip(*runs))
        color, lang, _, state = runs[0]
        grads = [blend_backward(counts, origins, attrs, livet, color, lang, state,
                                *gs, 3, 16, chunk) for _ in range(2)]
        bwd_rep = torch.equal(*grads)
        ends = [walk_end(int(c), k, chunk) for c in counts[:, 0]]
        seg_len = [segment_bounds(e, KERNEL_SEGMENTS)[0][1] for e in ends]
        extra = {}
        if name == "train_16384":
            # color and log T in the loss, the features unused (a None
            # cotangent, zeros in the Function)
            x1 = attrs.clone().requires_grad_()
            c1, _, l1 = blend_tiles(counts, origins, x1, livet, 3, 16, chunk)
            ((c1 * gs[0]).sum() + (l1 * gs[2]).sum()).backward()
            x2 = attrs.clone().requires_grad_()
            c2, _, l2 = blend_tiles_reference(counts, origins, x2, livet, 3, 16, chunk)
            ((c2 * gs[0]).sum() + (l2 * gs[2]).sum()).backward()
            unused = mostly_close(x1.grad.cpu(), x2.grad.cpu(), 2e-4, 1e-3, 0.02)
            extra["unused_output_bwd_frac_outside_max_diff"] = unused[1:]
            extra["unused_output_ok"] = unused[0]
        ok = (all(x[0] for x in fwd) and bwd[0] and fwd_rep and bwd_rep
              and extra.get("unused_output_ok", True))
        log("kernel_check", kernel="blend_tiles", frame=name, tiles=t, capacity=k,
            chunk=chunk, gaussians=n_gauss, splats_binned=int(counts.clamp(min=0).sum()),
            tiles_count_0=int((counts[:, 0] <= 0).sum()),
            tiles_walk_end_not_a_multiple_of_segment=sum(
                1 for e, sl in zip(ends, seg_len) if sl and e % sl),
            fwd_frac_outside_max_diff=[x[1:] for x in fwd],
            bwd_frac_outside_max_diff=bwd[1:], fwd_bitwise_repeatable=fwd_rep,
            bwd_bitwise_repeatable=bwd_rep, rule=rule, **extra, ok=ok)
        if not ok:
            raise AssertionError(f"blend kernels disagree ({name}): fwd {fwd} "
                                 f"bwd {bwd} repeatable {fwd_rep} {bwd_rep} {extra}")
        if name == "train_16384":
            errs = {"fwd": max(x[2] for x in fwd), "bwd": bwd[2]}
        if name in ("train_16384", "frame_65536", "bench_k8192_chunk512"):
            frames[name] = (counts, origins, attrs, livet, gs, chunk, n_gauss)
    phase_golden()

    records = {}
    for name, (counts, origins, attrs, livet, gs, chunk, n_gauss) in frames.items():
        t, c, k = attrs.shape
        work = blend_work(counts, origins, attrs, livet, chunk)
        color, lang, logtf, state = blend_forward(counts, origins, attrs, livet,
                                                  3, 16, chunk)
        ar = attrs.clone().requires_grad_()
        rout = blend_tiles_reference(counts, origins, ar, livet, 3, 16, chunk)
        inputs = 4.0 * (attrs.numel() + livet.numel() + 3 * t)
        outputs = 4.0 * t * 256 * 7
        fns = {
            "fwd": (lambda: blend_forward(counts, origins, attrs, livet, 3, 16, chunk),
                lambda: blend_tiles_reference(counts, origins, attrs, livet, 3, 16, chunk),
                inputs + outputs + 4.0 * state.numel(), inputs + outputs),
            "bwd": (lambda: blend_backward(
                counts, origins, attrs, livet, color, lang, state, *gs, 3, 16,
                chunk),
                lambda: torch.autograd.grad(rout, ar, gs, retain_graph=True),
                inputs + outputs + 4.0 * (state.numel() + attrs.numel()),
                inputs + outputs + 4.0 * attrs.numel()),
        }
        for kind, (fn, plain, nbytes, old_bytes) in fns.items():
            kernels = {}
            dev = device_ms(fn, iters=20, warmup=2, by_kernel=kernels)
            times = {"ms": dev, "host_loop_ms": cuda_ms(fn, iters=20),
                     "plain_ms": device_ms(plain, iters=3, warmup=1),
                     "plain_host_loop_ms": cuda_ms(plain, iters=3, warmup=1)}
            bnd = blend_bound(kind, work, nbytes, old_bytes)
            rec = {**times, "library_ms": None, **bnd,
                   "factor_vs_bound": dev / bnd["bound_ms"],
                   "factor_vs_old_bound": dev / bnd["old_bound_ms"]}
            log("kernel_time", kernel=f"blend_{kind}", frame=name, tiles=t,
                capacity=k, chunk=chunk, gaussians=n_gauss,
                segments=KERNEL_SEGMENTS, **work, bytes=nbytes,
                old_bytes=old_bytes, kernels=kernels, **rec)
            if name == "train_16384":
                records[f"blend_{kind}"] = {
                    "name": f"blend_{kind}", "route": "cuda",
                    "source": "manigaussian_tpu_torch/csrc/blend.cu",
                    "replaces": ("manigaussian_tpu/ops/pallas_blend.py:317"
                                 if kind == "fwd" else
                                 "manigaussian_tpu/ops/pallas_blend.py:339"),
                    "launches": None, "max_abs_err": errs[kind], **rec}
            else:
                records[f"blend_{kind}"][name] = {**rec, **work}
    return records


def blend_times() -> dict:
    """The blend pair's times through `blend_tiles` and autograd only (the
    public path, the same in older checkouts), at the training frame (16,384
    random Gaussians at 128², K 2048) and the 65,536 frame: the forward on
    inputs that need the gradient, as training calls it, and the backward,
    on the device reading with the host loop's beside it; and the device
    memory one forward and backward add at their peak over what their
    inputs hold (the residuals the forward saves among it)."""
    import torch
    from manigaussian_tpu_torch.ops.blend import blend_tiles

    gen = torch.Generator(device="cuda").manual_seed(1)
    times = {}
    for n in (16384, 65536):
        counts, origins, attrs, livet = random_frame(n, 128, 0)[:4]
        gs = [torch.randn(attrs.shape[0], c, 256, generator=gen, device="cuda")
              for c in (3, 3, 1)]
        ag = attrs.clone().requires_grad_()
        fwd = lambda: blend_tiles(counts, origins, ag, livet, 3, 16, 256)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(fwd(), ag, gs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        outs = fwd()
        bwd = lambda: torch.autograd.grad(outs, ag, gs, retain_graph=True)
        times[f"gaussians_{n}"] = {
            kind: {"device": device_ms(fn, iters=20, warmup=2),
                   "host_loop": cuda_ms(fn, iters=20, warmup=2)}
            for kind, fn in (("fwd", fwd), ("bwd", bwd))}
        times[f"gaussians_{n}"]["peak_bytes_over_inputs"] = peak
    log("blend_times", image=[128, 128], capacity=2048, chunk=256, ms=times)
    return times


def phase_bench(counters: dict) -> dict:
    """The bench twin (`manigaussian_tpu_torch/bench.py`, the root bench's
    workload: 65,536 Gaussians at 128², K 8192, chunk 512, the gradient of
    every input) on the kernel route through its `run` (one warm-up, 30
    timed renders), with the counts set to 0 just before and read just
    after: one blend forward and one backward a render, nothing else. Then
    one render's device time and the blend pair's share of it (summed kernel
    durations under torch.profiler), the device time inside each of the
    rasterizer's named ranges (preprocess, bin/sort, gather, blend; the
    backward the rest), the busy share, and the peak memory of a render
    above its inputs."""
    import torch
    from manigaussian_tpu_torch import bench

    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    res = bench.run(65536, 128, device="cuda")
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    renders = 1 + bench.ITERS
    expect = {k: 0 for k in counters} | {"blend_fwd": renders,
                                         "blend_bwd": renders}

    gen = torch.Generator().manual_seed(0)
    scene = bench.make_scene(65536, gen, "cuda")
    target = torch.rand(128, 128, 3, generator=gen).cuda()
    camera, cfg = bench.make_camera(128, "cuda"), bench.bench_config(128)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads, _ = bench.loss_and_grads(scene, camera, cfg, target)
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    step = lambda: float(bench.loss_and_grads(scene, camera, cfg, target)[0])
    prof = phase_profile(step, "bench render: fwd+bwd, 65,536 Gaussians, "
                         "128², K 8192, chunk 512", calls=5,
                         ranges_of="rasterize/", phase="bench_profile")
    kernels = {}
    render_ms = device_ms(step, iters=10, warmup=2, by_kernel=kernels)
    blend = {k: v for k, v in kernels.items() if "blend_" in k}
    blend_ms = sum(blend.values())
    ok = launches == expect and finite and res["value"] > 0
    log("bench", **res, iters=bench.ITERS, run_s=run_s, launches=launches,
        expected=expect, finite=finite, device_ms_per_render=render_ms,
        blend_pair_device_ms=blend_ms, blend_kernels_ms=blend,
        blend_pair_share_of_render=blend_ms / render_ms,
        range_device_ms=prof["range_kernel_ms_per_call"],
        wall_ms_per_render_profiled=prof["wall_ms_per_call"],
        device_busy_share=prof["device_busy_share"],
        peak_bytes_above_inputs=peak, ok=ok)
    if not ok:
        raise AssertionError(f"the bench failed its checks: {launches} "
                             f"finite {finite}")
    return {"launches": launches, "renders_per_s": res["value"]}


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


# The conv kernels against their plain versions, relative to max(1, max|plain|).
# float32: plain FMA against a float32 matmul, other summation order. bfloat16:
# both multiply the same bf16 values exactly and differ in the order and the
# rounding of the float32 accumulation (the tensor cores do not round to
# nearest): over 27·Ci terms in the forward and dx, over every voxel in dW,
# where one bf16 step (2^-8) is what dW is rounded to on its way to the
# parameter anyway.
CONV_TOL = {"float32": {"fwd": 1e-5, "dw": 1e-5},
            "bfloat16": {"fwd": 1e-3, "dw": 2.0 ** -8}}


def ptxas_report(source: str, kernel: str) -> dict:
    """Registers and spill bytes of the entry functions whose mangled name
    contains `kernel` (the most registers and the spill summed over a
    template's instantiations), and whether ptxas serialized their wgmma,
    from the compiler's log beside the built library."""
    import re
    from manigaussian_tpu_torch.ops import _cuda
    text = _cuda.library_path(source).with_suffix(".log").read_text()
    found = re.findall(r"Compiling entry function '[^']*" + re.escape(kernel)
                       + r"[^']*'.*?(\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads.*?Used (\d+) registers", text, re.S)
    if not found:
        raise AssertionError(f"no ptxas report for {kernel} in {source}.log")
    return {"registers": max(int(m[2]) for m in found),
            "spill_bytes": sum(int(m[0]) + int(m[1]) for m in found),
            "instantiations": len(found),
            "wgmma_serialized": bool(re.search(
                r"C75(?:12|20)[^\n]*" + re.escape(kernel), text))}


def phase_conv() -> dict:
    """The 3³ conv kernels: forward, dx (the forward kernel on dy with the
    taps flipped and Ci/Co swapped) and dW by the workspace and the resident
    scheme, against the plain versions on the card, at small ragged shapes in
    fp32 and bf16 (among them a batch of 2 whose voxel tiles straddle the
    samples at 128 → 128 channels, and 128 ↔ 256 channels for a forward and a
    dx over two 128-wide tiles) and at the policy's two 100³ convs in bf16;
    the two dW schemes, two independent sums, against each other, and each
    bitwise equal across two runs; ptxas's registers and spill of the two
    wgmma kernels (no spill allowed); then the time of each kernel, of its
    plain version and of the library call (F.conv3d, conv3d_weight: a
    yardstick only) beside its bound."""
    import torch
    import torch.nn.functional as F
    from manigaussian_tpu_torch.ops.conv3d import (conv3d_dw_reference,
                                                   conv3d_dw_resident,
                                                   conv3d_dw_workspace,
                                                   conv3d_forward,
                                                   conv3d_same_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    rel = lambda got, ref: ((got.float() - ref).abs().max()
                            / max(1.0, ref.abs().max().item())).item()

    def check(label, dtype, b, d, h, w, ci, co):
        dt = getattr(torch, dtype)
        x = torch.randn(b, d, h, w, ci, generator=gen, device="cuda").to(dt)
        wm = (0.05 * torch.randn(27, ci, co, generator=gen, device="cuda")).to(dt)
        dy = torch.randn(b, d, h, w, co, generator=gen, device="cuda").to(dt)
        w_flip = wm.flip(0).transpose(1, 2).contiguous()
        y_ref = conv3d_same_reference(x, wm)
        y_scale = max(1.0, y_ref.abs().max().item())
        errs = {"fwd": rel(conv3d_forward(x, wm), y_ref),
                "dx": rel(conv3d_forward(dy, w_flip),
                          conv3d_same_reference(dy, w_flip))}
        ref = conv3d_dw_reference(x, dy)
        same, got = {}, {}
        for name, fn in (("dw_workspace", conv3d_dw_workspace),
                         ("dw_resident", conv3d_dw_resident)):
            got[name] = fn(x, dy)
            errs[name] = rel(got[name], ref)
            same[name] = torch.equal(fn(x, dy), got[name])
        # kernel against kernel: each is within tol of the plain version
        errs["dw_workspace_vs_resident"] = rel(got["dw_workspace"],
                                               got["dw_resident"])
        torch.cuda.synchronize()
        tol = CONV_TOL[dtype]
        ok = (errs["fwd"] <= tol["fwd"] and errs["dx"] <= tol["fwd"]
              and errs["dw_workspace"] <= tol["dw"]
              and errs["dw_resident"] <= tol["dw"]
              and errs["dw_workspace_vs_resident"] <= 2 * tol["dw"]
              and all(same.values()))
        log("kernel_check", kernel="conv3d", conv=label, dtype=dtype,
            shape=[b, d, h, w, ci], co=co, compared_with="the plain version",
            err_over_scale=errs, tol=tol, bitwise_repeatable=same, ok=ok)
        if not ok:
            raise AssertionError(f"conv kernels disagree ({label}, {dtype}): "
                                 f"{errs} {same}")
        return x, wm, dy, errs, y_scale, max(1.0, ref.abs().max().item())

    for shape in ((1, 5, 6, 7, 8, 16), (2, 9, 10, 11, 24, 40),
                  (1, 12, 13, 14, 72, 136), (2, 12, 13, 14, 128, 128),
                  (1, 6, 7, 9, 128, 256), (1, 6, 7, 9, 256, 128)):
        for dtype in ("float32", "bfloat16"):
            check("ragged", dtype, *shape)

    build = {"conv3d_fwd": ptxas_report("conv3d", "conv3d_fwd_wgmma_kernel"),
             "conv3d_dw": ptxas_report("conv3d", "conv3d_dw_wgmma_kernel")}
    log("kernel_build", source="manigaussian_tpu_torch/csrc/conv3d.cu", **build)
    if any(b["spill_bytes"] or b["wgmma_serialized"] for b in build.values()):
        raise AssertionError(f"the wgmma conv kernels spill or serialize: {build}")

    records = {}
    for label, ci, co in (("final 256→128", 256, 128),
                          ("up0 post-resize 128→128", 128, 128)):
        x, wm, dy, errs, y_scale, dw_scale = check(label, "bfloat16", 1, 100,
                                                   100, 100, ci, co)
        xl, gl = (t.permute(0, 4, 1, 2, 3) for t in (x, dy))   # NCDHW views
        wl = wm.reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        w_flip = wm.flip(0).transpose(1, 2).contiguous()
        flops = 2.0 * x.shape[:4].numel() * 27 * ci * co
        el = x.element_size()
        # each input read once, each output written once
        nbytes = {"fwd": el * (x.numel() + wm.numel()) + 4.0 * dy.numel(),
                  "dw": el * (x.numel() + dy.numel()) + 4.0 * wm.numel()}
        lib_dw = lambda: torch.nn.grad.conv3d_weight(xl, wl.shape, gl, padding=1)
        cases = (
            ("conv3d_fwd", "fwd", errs["fwd"] * y_scale, {
                "ms": lambda: conv3d_forward(x, wm),
                "dx_ms": lambda: conv3d_forward(dy, w_flip),
                "plain_ms": lambda: conv3d_same_reference(x, wm),
                "library_ms": lambda: F.conv3d(xl, wl, padding=1)}),
            ("conv3d_dw", "dw", errs["dw_workspace"] * dw_scale, {
                "ms": lambda: conv3d_dw_workspace(x, dy),
                "plain_ms": lambda: conv3d_dw_reference(x, dy),
                "library_ms": lib_dw}),
            ("conv3d_dw_resident", "dw", errs["dw_resident"] * dw_scale, {
                "ms": lambda: conv3d_dw_resident(x, dy),
                "plain_ms": lambda: conv3d_dw_reference(x, dy),
                "library_ms": lib_dw}))
        for name, kind, err, fns in cases:
            times = {key: cuda_ms(fn, iters=2 if key == "plain_ms" else 10,
                                  warmup=1 if key == "plain_ms" else 3)
                     for key, fn in fns.items()}
            bound_ms, bound_by = bound(flops, nbytes[kind], PEAK_FLOPS["bfloat16"])
            log("kernel_time", kernel=name, conv=label,
                shape=[1, 100, 100, 100, ci], co=co, dtype="bfloat16",
                flops=flops, bytes=nbytes[kind], **times, bound_ms=bound_ms,
                bound_by=bound_by, tflops=flops / times["ms"] / 1e9,
                factor_vs_bound=times["ms"] / bound_ms,
                factor_vs_library=times["ms"] / times["library_ms"],
                **build.get(name, {}))
            if ci == 256:   # the record's shape: the larger of the two convs
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "manigaussian_tpu_torch/csrc/conv3d.cu",
                    "replaces": {
                        "conv3d_fwd": "manigaussian_tpu/ops/pallas_conv.py:126",
                        "conv3d_dw": "manigaussian_tpu/ops/pallas_conv.py:158",
                        "conv3d_dw_resident": "scripts/r4_pallas_dw_repro.py:120",
                    }[name],
                    "launches": None, "max_abs_err": err, **times,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "shape": f"[1,100,100,100,{ci}] -> {co}, bfloat16"}
            else:
                records[name]["up0_128_to_128"] = {**times, "bound_ms": bound_ms}
        del x, wm, dy, xl, gl, wl, w_flip, cases, fns, lib_dw
        torch.cuda.empty_cache()
    return records


def phase_small() -> None:
    import torch
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.ops.conv3d import conv3d_forward
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
    # edge padding, edge padding in bf16 (compared by the route rule; head
    # dim 16, as the bf16 kernel takes multiples of 16), and the conv kernels
    # in fp32 and bf16
    for dtype, pad, conv in (("float32", "zero", "z2d"), ("float32", "edge", "xla"),
                             ("bfloat16", "edge", "xla"),
                             ("float32", "zero", "pallas"),
                             ("bfloat16", "zero", "pallas")):
        cfg = dataclasses.replace(micro, method=dataclasses.replace(
            micro.method, policy_dtype=dtype, policy_pad_mode=pad,
            policy_conv_impl=conv,
            latent_dim_head=(16 if dtype == "bfloat16"
                             else micro.method.latent_dim_head)))
        gpu = ManiGaussianBCAgent(cfg, device="cuda", seed=0)
        cpu = ManiGaussianBCAgent(cfg, device="cpu", seed=0)
        before = flash_self_attention.launches
        conv_before = conv3d_forward.launches
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
              and flash_self_attention.launches > before
              and (conv3d_forward.launches - conv_before
                   == (4 if conv == "pallas" else 0)))
        log("small_reference", config=f"micro_variant(w_geo) {dtype} pad={pad} "
            f"conv={conv}, 16x16", max_abs_err=errs, tol=tols,
            same_discrete_action=same, ok=ok)
        if not ok:
            raise AssertionError(f"card and CPU disagree on the small input: {errs}")


def drive_eval(counters: dict, logdir: str, demos: str):
    """The port's eval entry point on the mock env from the newest checkpoint
    under `logdir`, with the counts set to 0 just before and read just after.
    Returns (act calls, launches, the result rows, seconds, each act's wall
    ms to a finished result); raises unless every act returned a finite
    [1, 9] action."""
    import torch
    from manigaussian_tpu_torch import eval as eval_cli
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent

    calls, shapes, finite, act_ms = [0], [], [], []
    orig_act = ManiGaussianBCAgent.act

    def counted_act(self, observation):
        t_start = time.perf_counter()
        res = orig_act(self, observation)
        torch.cuda.synchronize()
        act_ms.append((time.perf_counter() - t_start) * 1e3)
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
    if not (all(s == [1, 9] for s in shapes) and all(finite)):
        raise AssertionError(f"act returned {shapes}, finite {finite}")
    return calls[0], launches, rows, eval_s, act_ms


def phase_slice(counters: dict) -> dict:
    from manigaussian_tpu_torch import config as C
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

    calls, launches, rows, eval_s, act_ms = drive_eval(counters, logdir, demos)
    expected = m.transformer_depth * calls
    ok = (calls >= 2
          and launches["flash_self_attention_fwd"] == expected
          and all(v == 0 for k, v in launches.items()
                  if k != "flash_self_attention_fwd")
          and len(rows) == 1 and "eval_envs/return" in rows[0])
    log("slice", config="w_geo", voxel=m.voxel_sizes[0],
        latents=[m.num_latents, m.latent_dim], depth=m.transformer_depth,
        heads=[m.latent_heads, m.latent_dim_head], dtype=m.policy_dtype,
        camera=list(cfg.rlbench.camera_resolution), params=n_params,
        act_calls=calls, launches=launches, expected_flash=expected,
        rows=rows, setup_s=setup_s, eval_s=eval_s, act_ms=act_ms,
        act_ms_median=statistics.median(act_ms), ok=ok)
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


def phase_profile(step, label: str, calls: int = 3,
                  ranges_of: str = "update/", phase: str = "profile") -> dict:
    """Where one call's time goes: torch.profiler over `calls` calls of
    `step` (which ends in a device→host copy) — wall time, summed kernel
    time (the device's busy share, one stream), the device time of the
    kernels started inside each named range `ranges_of`* (the backward's:
    the rest), the kernels and the aten ops with the most device time, all
    per call."""
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
    named = lambda key: key.startswith(RANGE_PREFIXES)
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not named(e.key)),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key) / 1e3 / calls
    blend_ms = sum(e.self_device_time_total for e in kernels
                   if "blend_" in e.key) / 1e3 / calls
    # device time of the kernels that start inside each range's device span;
    # autograd launches the backward's kernels from its own thread, outside
    # the "update/backward" range, so the backward's share is the rest
    flat = prof.events()
    spans = [e for e in flat if e.name.startswith(ranges_of)
             and e.device_type == DeviceType.CUDA]
    kern = [e.time_range for e in flat
            if e.device_type == DeviceType.CUDA and not named(e.name)]
    ranges = {}
    for e in spans:
        inside = sum(k.elapsed_us() for k in kern
                     if e.time_range.start <= k.start < e.time_range.end)
        ranges[e.name] = ranges.get(e.name, 0.0) + inside / 1e3 / calls
    if ranges:
        ranges[ranges_of + "backward (the rest)"] = (device_ms
                                                     - sum(ranges.values()))

    def rows(evs, attr, n=14):
        return [[e.key[:90], round(getattr(e, attr) / 1e3 / calls, 4),
                 e.count / calls] for e in evs[:n]]

    out = dict(route="kernel", label=label, calls=calls, wall_ms_per_call=wall_ms,
               kernel_ms_per_call=device_ms, range_kernel_ms_per_call=ranges,
               device_busy_share=device_ms / wall_ms if wall_ms else None,
               kernels_launched_per_call=sum(e.count for e in kernels) / calls,
               flash_kernel_ms_per_call=flash_ms,
               blend_kernel_ms_per_call=blend_ms,
               top_kernels_ms_count=rows(kernels, "self_device_time_total"),
               top_aten_ops_device_ms_count=rows(ops, "device_time_total"))
    log(phase, **out)
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
        # the next frame (read by the dynamic-field tier only)
        "nerf_next_target_rgb": rng.uniform(size=(b, hw, hw, 3)).astype(f),
        "nerf_next_target_pose": np.tile(np.eye(4, dtype=f), (b, 1, 1)),
        "nerf_next_target_intrinsic": np.tile(intr, (b, 1, 1)),
    } | {"action": (0.1 * rng.standard_normal((b, 8))).astype(f)}


def phase_small_train(counters: dict) -> None:
    """The micro configs' `update`, card against CPU: fp32, dropout rates 0,
    the same augmentation draws; `w_geo` on the default conv route, and
    `w_geo_dyna` and `w_geo_sem_dyna` with `policy_conv_impl="pallas"` and
    the warm-up gate open (two renders, the deformation field, the conv
    kernels in fp32; the semantic tier with one `gt_embed` for both sides,
    so the blend backward's feature rows carry the embed loss's gradient).
    Losses within 1e-4·max(1, |loss|), every parameter gradient within
    1e-3·max|g| of its leaf plus 1e-5 (the floor covers a leaf whose exact
    gradient is zero, such as the trans decoder's bias: the gradient of a
    bias shared by all logits of a softmax is Σp − 1, rounding noise on both
    devices), and every counter of the route advanced."""
    import torch
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.ops.augmentation import sample_se3_draws

    from manigaussian_tpu_torch.models.foundation import StubFeatureExtractor

    conv = ("conv3d_fwd", "conv3d_dw", "conv3d_dw_resident")
    blend = ("blend_fwd", "blend_bwd")
    # (phase, variant, method, conv route, the counters that stay at 0);
    # GNFACTOR_BC's NeRF draws its rays and samples from the CPU generator,
    # so both devices render the same rays
    for label, variant, method, conv_impl, idle in (
            ("small_train", "w_geo", "ManiGaussian_BC", "z2d", conv),
            ("small_train", "w_geo_dyna", "ManiGaussian_BC", "pallas",
             conv[2:]),
            ("small_train", "w_geo_sem_dyna", "ManiGaussian_BC", "pallas",
             conv[2:]),
            ("gnf_small", "w_geo", "GNFACTOR_BC", "z2d", conv + blend)):
        cfg = C.micro_variant(variant)
        nr = cfg.method.neural_renderer
        cfg = dataclasses.replace(cfg, method=dataclasses.replace(
            cfg.method, name=method, input_dropout=0.0, attn_dropout=0.0,
            policy_conv_impl=conv_impl, neural_renderer=dataclasses.replace(
                nr, next_mlp=dataclasses.replace(nr.next_mlp, warm_up=0))))
        gnf = method == "GNFACTOR_BC"
        batch = micro_train_batch()
        sem = bool(nr.foundation_model_name)
        if sem:
            # one ground-truth embedding, made on the CPU, for both sides
            batch["gt_embed"] = StubFeatureExtractor(device="cpu").embed_fn(
                nr.d_embed)(batch["nerf_target_rgb"])
        draws = sample_se3_draws(torch.Generator().manual_seed(3), 2,
                                 cfg.method.aug_rpy,
                                 cfg.method.rotation_resolution)
        agents = {dev: create_agent(cfg, device=dev, seed=0)
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
              and all((v == 0) == (k in idle) for k, v in advanced.items())
              and (variant == "w_geo" or (metrics["cuda"]["dyna_loss"] > 0
                                          and advanced["blend_fwd"] == 2))
              and (metrics["cuda"]["embed_loss"] != 0) == sem
              and (not gnf or (metrics["cuda"]["dyna_loss"] == 0
                               and metrics["cuda"]["rgb_loss"] > 0)))
        log(label, config=f"micro_variant({variant}) {method} fp32, "
            f"dropout 0, batch 2, conv={conv_impl}",
            losses_cuda=metrics["cuda"], loss_rel_err=loss_err,
            worst_grad_err_over_tol=worst, launches=advanced,
            tol={"loss": "1e-4·max(1,|loss|)",
                 "grad": "1e-3·max|g| per leaf + 1e-5"},
            ok=ok)
        if not ok:
            raise AssertionError(f"the micro update ({variant}, {method}) "
                                 "disagrees "
                                 f"between card and CPU: {loss_err} {worst} "
                                 f"{advanced}")


# the SD VAE on the card against the CPU: each output within VAE_TOL of its
# scale (fp32; cuDNN and the CPU sum the convolutions in other orders); the
# GT embedding (the same PCA Ω on both) per image and channel up to a sign
# within EMBED_TOL of its scale
VAE_TOL = 1e-4
EMBED_TOL = 1e-3


def vae_flops(hw: int, **dims) -> float:
    """Operations of one SD VAE forward (models/sd_vae.py, to the last
    decoder tap) on one hw² image, counted from the shapes on the meta
    device: 2·outputs·Cin·k² a convolution, 4·N²·C an attention (q·kᵀ and
    p·v). Norms and activations are not counted."""
    import torch
    from manigaussian_tpu_torch.models import sd_vae as sv
    total = [0.0]

    def conv_hook(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.weight[0].numel()

    def attn_hook(mod, inp, out):
        b, c, h, w = inp[0].shape
        total[0] += 4.0 * b * (h * w) ** 2 * c

    with torch.device("meta"):
        model = sv.SDVae(**dims)
        x = torch.zeros(1, 3, hw, hw)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(conv_hook)
        elif isinstance(mod, sv.AttnBlock):
            mod.register_forward_hook(attn_hook)
    with torch.no_grad():
        model(x)
    return total[0]


def phase_sem_check() -> dict:
    """The semantic tier's frozen tower on the card. (1) The SD VAE at ch 32
    on two 64² images, fp32, card against CPU: the latent and the encoder
    and decoder taps within VAE_TOL of their scale; the GT-embed pipeline
    (`embed_fn`: resize → VAE → tap → resize → PCA) on two 32² views at a
    64² feature size, within EMBED_TOL up to a sign per image and channel.
    (2) At SD v1 width (random-init, ch 128) on one 512² image: the device
    time of the forward (summed kernel durations, and the host loop's
    events), its TFLOP/s on the operations `vae_flops` counts, the same with
    cuDNN's TF32 convolutions, and the peak memory of the forward above what
    was allocated before it. (3) `embed_fn`'s wall time for a batch of one
    128² view, the prefetch thread's work a `w_geo_sem_dyna` step."""
    import copy
    import numpy as np
    import torch
    from manigaussian_tpu_torch.models import foundation as fd
    from manigaussian_tpu_torch.models import sd_vae as sv

    gen = torch.Generator().manual_seed(1)
    cpu = sv.SDVae(ch=32).init_params(torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.rand(2, 3, 64, 64, generator=gen) * 2 - 1
    with torch.no_grad():
        oc, og = cpu(x), gpu(x.cuda())
    errs = {}
    for part in ("latent", "encoder_features", "decoder_features"):
        refs = oc[part] if isinstance(oc[part], list) else [oc[part]]
        gots = og[part] if isinstance(og[part], list) else [og[part]]
        errs[part] = [((g.cpu() - r).abs().max() / r.abs().max()).item()
                      for g, r in zip(gots, refs)]
    path = os.path.join(WORK, "sd_vae_ch32.pt")
    torch.save(cpu.state_dict(), path)
    rgb = np.random.default_rng(1).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    emb = {dev: fd.SDVaeFeatureExtractor(path, feature_hw=64, device=dev)
           .embed_fn(3)(rgb) for dev in ("cpu", "cuda")}
    embed_err = float(max(
        min(np.abs(emb["cuda"][i, ..., k] - emb["cpu"][i, ..., k]).max(),
            np.abs(emb["cuda"][i, ..., k] + emb["cpu"][i, ..., k]).max())
        / np.abs(emb["cpu"][i, ..., k]).max()
        for i in range(2) for k in range(3)))
    small_ok = (all(e <= VAE_TOL for v in errs.values() for e in v)
                and embed_err <= EMBED_TOL)
    del cpu, gpu, og

    ex = fd.SDVaeFeatureExtractor(None, device="cuda")
    img = (torch.rand(1, 3, ex.feature_hw, ex.feature_hw, generator=gen)
           * 2 - 1).cuda()

    def forward():
        with torch.no_grad():
            return ex.model(img)["decoder_features"][-1]

    flops = vae_flops(ex.feature_hw)
    weights = sum(p.numel() * p.element_size() for p in ex.model.parameters())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tap = forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    tap_ok = (list(tap.shape) == [1, 512, ex.feature_hw // 4,
                                  ex.feature_hw // 4]
              and bool(torch.isfinite(tap).all()))
    del tap
    dev_ms = device_ms(forward, iters=5, warmup=1)
    host_ms = cuda_ms(forward, iters=5, warmup=1)
    # the same forward with cuDNN's TF32 convolutions, PyTorch's default
    # outside this script (which turns TF32 off for its comparisons)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_ms = device_ms(forward, iters=5, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False

    embed = ex.embed_fn(3)
    view = np.random.default_rng(2).uniform(size=(1, 128, 128, 3)).astype(
        np.float32)
    out = embed(view)
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = embed(view)
        wall.append((time.perf_counter() - t0) * 1e3)
    embed_ok = (out.shape == (1, 128, 128, 3) and out.dtype == np.float32
                and bool(np.isfinite(out).all()))
    ok = small_ok and tap_ok and embed_ok
    log("sem_check", small="SDVae ch 32, 2×64², fp32, card vs CPU",
        rel_err=errs, tol=VAE_TOL,
        embed_rel_err_up_to_sign=embed_err, embed_tol=EMBED_TOL,
        full=f"SDVae ch 128 (random-init), 1×{ex.feature_hw}², fp32",
        tflop=flops / 1e12, device_ms=dev_ms, host_loop_ms=host_ms,
        tflops_per_s=flops / dev_ms / 1e9,
        fp32_bound_ms=flops / PEAK_FLOPS["float32"] * 1e3,
        device_ms_cudnn_tf32=tf32_ms,
        weight_bytes=weights, peak_bytes_of_the_forward=peak,
        embed_fn_wall_ms=wall, embed_fn_wall_ms_median=statistics.median(wall),
        ok=ok)
    if not ok:
        raise AssertionError(f"the SD VAE on the card failed its checks: "
                             f"{errs} {embed_err}")
    del ex, embed, img
    torch.cuda.empty_cache()
    return {"device_ms": dev_ms, "flops": flops}


# the RN50 text tower on the card against the CPU, fp32 (TF32 off): each
# output within CLIP_TOL of its scale (the two devices sum the matmuls in
# other orders)
CLIP_TOL = 1e-4


def phase_clip_check() -> dict:
    """The CLIP RN50 text tower (`models/clip_text.py`) at its published
    width (width 512, 12 layers, 8 heads, context 77, vocab 49408, embed
    1024) from seeded random weights: the card against the CPU on fixed
    token ids (the sentence and the token embeddings), then one encode's
    time on the card (host clock around the call and its copy to the host,
    and the device reading)."""
    import copy
    import torch
    from manigaussian_tpu_torch.models import clip_text as ct

    cpu = ct.ClipTextTransformer().init_params(
        torch.Generator().manual_seed(0)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    ids = torch.zeros(2, 77, dtype=torch.long)
    # <sot> … <eot> (the highest id, which the EOT pick finds), fixed ids
    ids[0, :6] = torch.tensor([49406, 1488, 518, 1253, 11965, 49407])
    ids[1, :31] = torch.cat([torch.tensor([49406]),
                             torch.arange(1000, 30000, 1000),
                             torch.tensor([49407])])
    with torch.no_grad():
        want = cpu(ids)
        got = gpu(ids.cuda())
    errs = {name: ((g.cpu() - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(("sentence", "tokens"), got, want)}

    def encode():
        with torch.no_grad():
            sent, toks = gpu(ids[:1].cuda())
        return sent.cpu(), toks.cpu()

    wall = []
    for _ in range(3):
        encode()
    for _ in range(10):
        t0 = time.perf_counter()
        encode()
        wall.append((time.perf_counter() - t0) * 1e3)
    dev = device_ms(lambda: gpu(ids[:1].cuda()), iters=10, warmup=2)
    ok = (all(e <= CLIP_TOL for e in errs.values())
          and list(got[0].shape) == [2, 1024] and list(got[1].shape) == [2, 77, 512]
          and all(bool(torch.isfinite(t).all()) for t in got))
    log("clip_check", tower="CLIP RN50 text, width 512, 12 layers, 8 heads, "
        "context 77, vocab 49408, embed 1024, seeded random weights, fp32",
        params=sum(p.numel() for p in cpu.parameters()), rel_err=errs,
        tol=CLIP_TOL, encode_wall_ms=wall,
        encode_wall_ms_median=statistics.median(wall),
        encode_device_ms=dev, ok=ok)
    if not ok:
        raise AssertionError(f"the CLIP text tower on the card disagrees with "
                             f"the CPU: {errs}")
    return {"encode_ms": statistics.median(wall)}


TASK = "open_drawer"
TRAIN_OVERRIDES = [f"rlbench.tasks=[{TASK}]", "rlbench.demos=2",
                   "replay.use_disk=false", "framework.log_freq=1",
                   "framework.save_freq=1000", "framework.num_weights_to_keep=2"]
# the dynamic-field tier on the conv kernels, its warm-up gate at step 2
DYNA_WARM_UP = 2
DYNA_OVERRIDES = ["method.policy_conv_impl=pallas",
                  f"method.neural_renderer.next_mlp.warm_up={DYNA_WARM_UP}"]
# the full model (w_geo_sem_dyna) the same way, its ground-truth embedding
# from the SD VAE with random weights: the real ODISE compute, not the stub
SEM_OVERRIDES = [*DYNA_OVERRIDES,
                 "method.neural_renderer.foundation_checkpoint=random-init"]


def train_config(variant: str, overrides=()):
    """The full-width config of the training phases, as the train entry point
    builds it: one task, two synthetic demos, in-memory replay, logs every
    step."""
    from manigaussian_tpu_torch.utils.config_io import load_config
    return load_config(None, [*TRAIN_OVERRIDES, *overrides], variant=variant)


# GNFACTOR_BC: the NeRF renderer in place of the splat world model
GNF_OVERRIDES = ["method.name=GNFACTOR_BC"]


def expected_launches(m, step: int) -> dict:
    """Kernel launches of one training step at batch 1: the flash forward and
    backward once per self-attention layer; one render, and a second one of
    the next frame once the dynamic field's warm-up gate is open (none with
    GNFACTOR_BC's NeRF); with the conv kernels, the forward and dx of the two
    full-resolution convs and one dW (workspace scheme) each."""
    nr = m.neural_renderer
    renders = 2 if nr.use_dynamic_field and step >= nr.next_mlp.warm_up else 1
    if m.name == "GNFACTOR_BC":
        renders = 0
    pallas = m.policy_conv_impl == "pallas"
    return {"flash_self_attention_fwd": m.transformer_depth,
            "flash_self_attention_bwd": m.transformer_depth,
            "blend_fwd": renders, "blend_bwd": renders,
            "conv3d_fwd": 4 if pallas else 0, "conv3d_dw": 2 if pallas else 0,
            "conv3d_dw_resident": 0}


def expected_vis_launches(m) -> dict:
    """Kernel launches of one recon render (`render_for_vis`, step 0): the
    policy's forward (the flash forward once per self-attention layer, with
    the conv kernels the two full-resolution conv forwards) and one blend
    forward of the splat renderer (its next frame waits for the gate)."""
    return {"flash_self_attention_fwd": m.transformer_depth,
            "flash_self_attention_bwd": 0,
            "blend_fwd": 0 if m.name == "GNFACTOR_BC" else 1, "blend_bwd": 0,
            "conv3d_fwd": 2 if m.policy_conv_impl == "pallas" else 0,
            "conv3d_dw": 0, "conv3d_dw_resident": 0}


def timed_calls(fn, wall_ms: list, cpu_ms: list):
    """`fn`, appending each call's wall time and the calling thread's CPU
    time (`time.thread_time`: Python, launches, and the spin-wait of the
    copy to the host) to the two lists, in ms."""
    def timed(*args):
        t_wall, t_cpu = time.perf_counter(), time.thread_time()
        out = fn(*args)
        cpu_ms.append((time.thread_time() - t_cpu) * 1e3)
        wall_ms.append((time.perf_counter() - t_wall) * 1e3)
        return out
    return timed


def phase_train_slice(counters: dict, variant: str = "w_geo", overrides=(),
                      steps: int = 6, demos: str = None,
                      label: str = "train_slice") -> dict:
    """The training path at full width through the port's train entry point
    (main()), then a resume from its checkpoint for 2 more steps. The counts
    are set to 0 just before the first run and read just after it: the
    steps' launches and the recon render's at step 0 (`render_for_vis`,
    `expected_vis_launches`). Also timed: each step's wait in
    `next(batches)` (the prefetch thread, which in the semantic tiers also
    runs the frozen tower), each GT-embedding call there, and the recon
    render (its image finite); recorded: the feature extractors the entry
    point built (one a run), and whether the recon panel was written."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.data.pipeline import BatchIterator
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.models import foundation
    from manigaussian_tpu_torch.rendering.neural_renderer import NeuralRenderer
    from manigaussian_tpu_torch.utils.checkpoint import list_checkpoints

    cfg = train_config(variant, overrides)
    m = cfg.method
    logdir = os.path.join(WORK, f"train_logs_{variant}_{m.name}")
    t0 = time.time()
    if demos is None:
        demos = os.path.join(WORK, "train_demos")
        generate_task(demos, TASK, num_episodes=2, timesteps=16,
                      h=cfg.rlbench.camera_resolution[0],
                      w=cfg.rlbench.camera_resolution[1], nerf_views=3,
                      nerf_hw=m.neural_renderer.image_height)
    setup_s = time.time() - t0

    per_step, expect, step_ms, metrics_seen = [], [], [], []
    overflow, rendered = [], []     # per step, per render: (splats, gaussians)
    wait_ms, extractors = [], []
    embed_wall_ms, embed_cpu_ms = [], []   # per call, in the calling thread
    vis = []          # per recon render: launches, wall ms, image
    orig_update = ManiGaussianBCAgent.update
    orig_vis = ManiGaussianBCAgent.render_for_vis
    orig_render = NeuralRenderer._render
    orig_next = BatchIterator.__next__
    orig_create = foundation.create_feature_extractor

    def timed_next(self):
        t_start = time.perf_counter()
        batch = orig_next(self)
        wait_ms.append((time.perf_counter() - t_start) * 1e3)
        return batch

    def recorded_create(*args, **kwargs):
        ex = orig_create(*args, **kwargs)
        extractors.append(type(ex).__name__)
        make = ex.embed_fn

        def timed_embed_fn(d_embed):
            return timed_calls(make(d_embed), embed_wall_ms, embed_cpu_ms)

        ex.embed_fn = timed_embed_fn
        return ex

    def watched_render(self, params, cameras):
        out = orig_render(self, params, cameras)
        rendered.append(out[2:])
        return out

    def counted_vis(self, batch):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        res = orig_vis(self, batch)
        torch.cuda.synchronize()
        rendered.clear()        # the recon render's frame is no step's
        vis.append({"wall_ms": (time.perf_counter() - t_start) * 1e3,
                    "launches": {k: fn.launches - before[k]
                                 for k, fn in counters.items()},
                    "shape": list(res.render_novel.shape),
                    "finite": bool(torch.isfinite(res.render_novel).all())})
        return res

    def counted_update(self, batch, generator, draws=None):
        before = {k: fn.launches for k, fn in counters.items()}
        expect.append(expected_launches(m, self.step))
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = orig_update(self, batch, generator, draws)
        float(out["total_loss"])                 # device→host copy
        step_ms.append((time.perf_counter() - t_start) * 1e3)
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
        metrics_seen.append({k: float(v) for k, v in out.items()})
        overflow.append([[float(v) for v in pair] for pair in rendered])
        rendered.clear()
        return out

    argv = ["--variant", variant, "--demo-root", demos, "--logdir", logdir,
            *TRAIN_OVERRIDES, *overrides]
    ManiGaussianBCAgent.update = counted_update
    ManiGaussianBCAgent.render_for_vis = counted_vis
    NeuralRenderer._render = watched_render
    BatchIterator.__next__ = timed_next
    foundation.create_feature_extractor = recorded_create
    try:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        train_cli.main([*argv, f"framework.training_iterations={steps}"])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ckpts = list_checkpoints(os.path.join(logdir, "seed0"))
        n_first, n_vis = len(per_step), len(vis)
        train_cli.main([*argv, f"framework.training_iterations={steps + 1}",
                        "framework.load_existing_weights=true"])
        torch.cuda.synchronize()
    finally:
        ManiGaussianBCAgent.update = orig_update
        ManiGaussianBCAgent.render_for_vis = orig_vis
        NeuralRenderer._render = orig_render
        BatchIterator.__next__ = orig_next
        foundation.create_feature_extractor = orig_create

    finite = all(np.isfinite(v) for row in metrics_seen for v in row.values())
    heads = ("total_loss", "bc_loss", "trans_loss", "rot_loss", "grip_loss",
             "collision_loss", "rgb_loss", "embed_loss", "dyna_loss", "psnr",
             "overflow_splats", "overflow_gaussians")
    dyna = (m.neural_renderer.use_dynamic_field
            and m.name != "GNFACTOR_BC")
    sem = bool(m.neural_renderer.foundation_model_name)
    img = m.neural_renderer.image_height, m.neural_renderer.image_width
    panel = os.path.isfile(os.path.join(logdir, "seed0", "recon", "0.png"))
    ok = (n_first == steps and len(per_step) == steps + 2 and finite
          and per_step == expect
          and [len(o) for o in overflow] == [e["blend_fwd"] for e in expect]
          and all(h in row for h in heads for row in metrics_seen)
          and all((row["dyna_loss"] > 0) == dyna for row in metrics_seen)
          and all((row["embed_loss"] != 0) == sem for row in metrics_seen)
          and len(extractors) == (2 if sem else 0)
          and ckpts == [steps - 1]
          and n_vis == 1 and len(vis) == 1
          and vis[0]["launches"] == expected_vis_launches(m)
          and vis[0]["shape"] == [1, *img, 3] and vis[0]["finite"]
          and launches == {k: sum(row[k] for row in expect[:n_first])
                           + vis[0]["launches"][k] for k in counters})
    warm = step_ms[2:n_first]
    log(label, config=variant, overrides=list(overrides),
        voxel=m.voxel_sizes[0],
        latents=[m.num_latents, m.latent_dim], depth=m.transformer_depth,
        heads=[m.latent_heads, m.latent_dim_head], dtype=m.policy_dtype,
        conv_impl=m.policy_conv_impl,
        image=[m.neural_renderer.image_height, m.neural_renderer.image_width],
        gaussians=int(np.prod(cfg.rlbench.camera_resolution)),
        dropout=[m.input_dropout, m.attn_dropout], batch=cfg.replay.batch_size,
        steps=steps, resumed_steps=len(per_step) - n_first, checkpoints=ckpts,
        launches=launches, launches_per_step=per_step, expected_per_step=expect,
        losses_first=metrics_seen[0], losses_last=metrics_seen[n_first - 1],
        overflow_per_step_and_render=overflow,
        step_ms=step_ms, step_ms_median_after_2=statistics.median(warm),
        next_batch_wait_ms=wait_ms,
        next_batch_wait_ms_median_after_2=statistics.median(
            wait_ms[2:n_first]),
        extractors=extractors, recon_render=vis,
        recon_render_expected_launches=expected_vis_launches(m),
        recon_panel_written=panel,
        embed_wall_ms=embed_wall_ms, embed_cpu_ms=embed_cpu_ms,
        embed_wall_ms_median=statistics.median(embed_wall_ms or [0.0]),
        embed_cpu_ms_median=statistics.median(embed_cpu_ms or [0.0]),
        peak_device_bytes=peak, setup_s=setup_s, train_s=train_s, ok=ok)
    if not ok:
        raise AssertionError(f"the {variant} training slice failed its checks")
    return {"launches": launches, "step_ms": statistics.median(warm),
            "demos": demos, "logdir": logdir, "cfg": cfg,
            "extractors": extractors, "peak": peak}


def phase_tier_slice(counters: dict, demos: str, variant: str, overrides,
                     label: str, act_label: str, steps: int = 6) -> dict:
    """A tier (or GNFACTOR_BC) at full width: `steps` training steps through
    the train entry point, a checkpoint, a resume for 2 more steps (with
    the dynamic field and the warm-up gate at step 2: one render a step
    before the gate, two after it and after the resume); then `act` through
    the eval entry point on that checkpoint: per act, the flash forward once
    per self-attention layer and, with `policy_conv_impl="pallas"`, the conv
    forward twice."""
    tr = phase_train_slice(counters, variant, overrides, steps=steps,
                           demos=demos, label=label)
    m = tr["cfg"].method
    calls, launches, rows, eval_s, act_ms = drive_eval(
        counters, os.path.join(tr["logdir"], "seed0"), demos)
    expect = {k: 0 for k in counters} | {
        "flash_self_attention_fwd": m.transformer_depth * calls,
        "conv3d_fwd": 2 * calls if m.policy_conv_impl == "pallas" else 0}
    ok = (calls >= 2 and launches == expect and len(rows) == 1
          and "eval_envs/return" in rows[0])
    log(act_label, config=variant, conv_impl=m.policy_conv_impl,
        act_calls=calls, launches=launches, expected=expect, rows=rows,
        eval_s=eval_s, act_ms=act_ms, act_ms_median=statistics.median(act_ms),
        ok=ok)
    if not ok:
        raise AssertionError(f"act on the {variant} checkpoint failed its "
                             "checks")
    return {**tr, "act_launches": launches, "act_calls": calls}


def phase_train_routes(demos: str, label: str, variant: str, overrides,
                       routes: dict, profile: str, vis: bool = False) -> dict:
    """One batch from the same weights through two routes (`routes`: name →
    fields of the method config and of its renderer), dropout 0, the same
    draws (and, in the semantic tiers, the same `gt_embed`, made once by the
    tier's extractor on the card): loss within ROUTE_TOL·max(1, |loss|),
    global gradient norm within ROUTE_TOL relative; the step time
    (alternating) and the act latency of each route; then torch.profiler
    over 2 training steps of route `profile`. With `vis`, first the recon
    render (`render_for_vis`) of route `profile` called directly, outside
    the runner's catch: its wall time and a finite image of the view's
    size.
    """
    import numpy as np
    import torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import assemble_batch, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.ops.augmentation import sample_se3_draws

    cfg = train_config(variant, overrides)
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, input_dropout=0.0, attn_dropout=0.0))
    replay = TaskUniformReplay()
    fill_replay(replay, demos, TASK, 2, cfg.rlbench.cameras,
                cfg.rlbench.scene_bounds, cfg.method.voxel_sizes[0],
                cfg.method.rotation_resolution, cfg.rlbench.episode_length,
                create_language_model("stub"))
    rng = np.random.default_rng(0)
    nr = cfg.method.neural_renderer
    embed_fn = None
    if nr.foundation_model_name:
        from manigaussian_tpu_torch.models.foundation import \
            create_feature_extractor
        embed_fn = create_feature_extractor(
            nr.foundation_model_name, nr.foundation_checkpoint,
            device="cuda").embed_fn(nr.d_embed)
    batch = assemble_batch(replay.sample(1, rng), rng,
                           cfg.method.num_view_for_nerf, embed_fn=embed_fn)
    del embed_fn
    draws = sample_se3_draws(torch.Generator().manual_seed(5), 1,
                             cfg.method.aug_rpy, cfg.method.rotation_resolution)
    agents = {}
    for route, (method_kw, renderer_kw) in routes.items():
        m = dataclasses.replace(cfg.method, **method_kw,
                                neural_renderer=dataclasses.replace(
                                    cfg.method.neural_renderer, **renderer_kw))
        agents[route] = create_agent(dataclasses.replace(cfg, method=m),
                                     device="cuda", seed=0)
    first, second = routes
    vis_rec = None
    if vis:
        a = agents[profile]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = a.render_for_vis(batch).render_novel
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        img = a.render_for_vis(batch).render_novel
        torch.cuda.synchronize()
        nr = cfg.method.neural_renderer
        vis_rec = {"wall_ms_first": wall,
                   "wall_ms": (time.perf_counter() - t0) * 1e3,
                   "shape": list(img.shape),
                   "finite": bool(torch.isfinite(img).all())}
        if vis_rec["shape"] != [1, nr.image_height, nr.image_width, 3] or \
                not vis_rec["finite"]:
            raise AssertionError(f"render_for_vis returned {vis_rec}")
    loss, gnorm, heads = {}, {}, {}
    for route, a in agents.items():
        out = a.update(batch, torch.Generator().manual_seed(0), draws=draws)
        loss[route] = float(out["total_loss"])
        heads[route] = {k: float(out[k]) for k in ("bc_loss", "rgb_loss",
                                                   "embed_loss", "dyna_loss")}
        gnorm[route] = float(torch.sqrt(sum((p.grad.float() ** 2).sum()
                                            for p in a.qfn.parameters()
                                            if p.grad is not None)))
    loss_diff = abs(loss[first] - loss[second])
    gnorm_rel = abs(gnorm[first] - gnorm[second]) / gnorm[second]

    def step(a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(a.update(batch, torch.Generator().manual_seed(0),
                       draws=draws)["total_loss"])
        return (time.perf_counter() - t0) * 1e3

    def act(a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.act(batch).continuous_action.cpu()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        for a in agents.values():
            step(a)
            act(a)
    lat = {r: [] for r in agents}
    act_lat = {r: [] for r in agents}
    for _ in range(5):
        for r, a in agents.items():
            lat[r].append(step(a))
    for _ in range(8):
        for r, a in agents.items():
            act_lat[r].append(act(a))
    ok = (all(np.isfinite(v) for v in loss.values())
          and loss_diff <= ROUTE_TOL * max(1.0, abs(loss[second]))
          and gnorm_rel <= ROUTE_TOL)
    log(label, config=variant, overrides=list(overrides),
        routes={r: {**kw[0], **kw[1]} for r, kw in routes.items()},
        loss=loss, loss_heads=heads, loss_abs_diff=loss_diff, grad_norm=gnorm,
        grad_norm_rel_diff=gnorm_rel, tol=ROUTE_TOL,
        step_ms_median={r: statistics.median(v) for r, v in lat.items()},
        step_ms=lat,
        act_ms_median={r: statistics.median(v) for r, v in act_lat.items()},
        act_ms=act_lat, render_for_vis=vis_rec, ok=ok)
    if not ok:
        raise AssertionError(f"the training routes of {label} disagree: "
                             f"{loss} {gnorm}")
    kept = agents[profile]
    del agents
    torch.cuda.empty_cache()
    prof = phase_profile(lambda: float(kept.update(
        batch, torch.Generator().manual_seed(0), draws=draws)["total_loss"]),
        f"{variant} {cfg.method.name} training step, route {profile}", calls=2)
    return {"profile": prof, "step_ms": statistics.median(lat[profile]),
            "act_ms": statistics.median(act_lat[profile]), "vis": vis_rec,
            "batch": batch, "cfg": cfg}


def phase_nerf_parts(batch, cfg) -> dict:
    """The GNFACTOR_BC NeRF's part of a training step, alone, at full width
    (`w_geo`: the renderer's 512 rays × (64 + 96) samples, MLP 512 × 5 in
    fp32, the bf16 100³ × 128 voxel features with a gradient), on one
    batch's target view: the device time of its loss forward, of forward
    and backward with its kernels by name, and of the trilinear gather's
    backward alone — the deterministic scatter (stable sort +
    segment_reduce) of both passes' 8 corners a point into the volume, at
    the corner indices the forward computed; the MLP's operations and its
    fp32 bound."""
    import torch
    from manigaussian_tpu_torch.agents.qfunction import renderer_from_config
    from manigaussian_tpu_torch.models.blocks import initialize
    from manigaussian_tpu_torch.ops.voxelize import segment_sum
    from manigaussian_tpu_torch.rendering import nerf_renderer as nrm

    m = dataclasses.replace(cfg.method, neural_renderer=dataclasses.replace(
        cfg.method.neural_renderer, renderer_type="nerf",
        use_dynamic_field=False))
    nr = m.neural_renderer
    r = initialize(renderer_from_config(m), torch.Generator().manual_seed(0))
    r = r.cuda().train()
    v = m.voxel_sizes[0]
    d0 = (torch.randn(1, v, v, v, nr.d_latent,
                      generator=torch.Generator().manual_seed(1)) * 0.1
          ).to(torch.bfloat16).cuda().requires_grad_()
    t = lambda k: torch.as_tensor(batch[k][:1], device="cuda").float()
    rgb, pose, intr = (t("nerf_target_rgb"), t("nerf_target_pose"),
                       t("nerf_target_intrinsic"))
    emb = rgb.new_zeros(*rgb.shape[:3], nr.d_embed)
    gen = lambda: torch.Generator().manual_seed(0)

    captured = []
    orig = nrm._CornerGather

    class Capture(orig):
        @staticmethod
        def forward(ctx, table, idx):
            captured.append(idx)
            return orig.forward(ctx, table, idx)

    nrm._CornerGather = Capture
    try:
        with torch.no_grad():
            r(d0, rgb, pose, intr, emb, gen())
    finally:
        nrm._CornerGather = orig

    def fwd():
        with torch.no_grad():
            return r(d0, rgb, pose, intr, emb, gen()).loss

    def fwd_bwd():
        d0.grad = None
        r.zero_grad(set_to_none=True)
        r(d0, rgb, pose, intr, emb, gen()).loss.backward()

    n_vox = d0.shape[0] * v ** 3
    rows = [torch.randn(i.numel(), nr.d_latent, device="cuda") for i in captured]
    scatter = lambda: [segment_sum(g, i, n_vox) for g, i in zip(rows, captured)]
    kernels = {}
    fb_ms = device_ms(fwd_bwd, iters=5, warmup=2, by_kernel=kernels)
    fwd_ms = device_ms(fwd, iters=5, warmup=2)
    scatter_ms = device_ms(scatter, iters=5, warmup=2)
    mlp = r.nerf.mlp
    macs = sum(p.numel() for n_, p in mlp.named_parameters()
               if n_.endswith("weight"))
    # the coarse pass's samples, then the fine pass's (coarse ∪ fine)
    points = nr.ray_chunk_size * (2 * nr.n_coarse + nr.n_fine)
    mlp_flops = 3 * 2 * macs * points            # forward + two backward GEMMs
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = dict(rays=nr.ray_chunk_size, samples=[nr.n_coarse, nr.n_fine,
                                               nr.n_fine_depth],
               points=points, corner_rows=[int(i.numel()) for i in captured],
               voxels=n_vox, channels=nr.d_latent,
               mlp=[mlp.lin_in.weight.shape[0], len(mlp.blocks)],
               forward_device_ms=fwd_ms, fwd_bwd_device_ms=fb_ms,
               trilinear_scatter_device_ms=scatter_ms,
               mlp_tflop_fwd_bwd=mlp_flops / 1e12,
               mlp_fp32_bound_ms=mlp_flops / PEAK_FLOPS["float32"] * 1e3,
               top_kernels_ms=[[k, round(x, 4)] for k, x in top])
    log("nerf_parts", **out)
    del r, d0, rows, captured
    torch.cuda.empty_cache()
    return out


def embed_ab(rounds: int = 3, steps: int = 5) -> dict:
    """Where the SD VAE's GT embedding runs in `w_geo_sem_dyna` training.
    One agent (the train slice's config: kernel route, pallas conv, random-
    init VAE; the gate open from step 0) and, for each design, a fresh
    `BatchIterator` over one replay with seed 0, so every design trains on
    the same batches. The designs, in rounds (A B C D, then D C B A, ...):
      own_stream     — the prefetch thread computes `gt_embed` on a CUDA
                       stream of its own (`make_embed_fn`'s design);
      default_stream — the prefetch thread, on the default stream;
      main_thread    — the main thread, between `next(batches)` and
                       `update`;
      none           — no tower: one fixed `gt_embed` (the step alone).
    Per design, after 2 warm-up steps: each step's wall time from
    `next(batches)` to the loss on the host, the wait in `next`, and each
    embedding call's wall and CPU time in its thread."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.models import foundation as fd

    cfg = train_config("w_geo_sem_dyna",
                       (*SEM_OVERRIDES,
                        "method.neural_renderer.next_mlp.warm_up=0"))
    m, nr = cfg.method, cfg.method.neural_renderer
    demos = os.path.join(WORK, "train_demos")
    generate_task(demos, TASK, num_episodes=2, timesteps=16,
                  h=cfg.rlbench.camera_resolution[0],
                  w=cfg.rlbench.camera_resolution[1], nerf_views=3,
                  nerf_hw=nr.image_height)
    replay = TaskUniformReplay()
    fill_replay(replay, demos, TASK, 2, cfg.rlbench.cameras,
                cfg.rlbench.scene_bounds, m.voxel_sizes[0],
                m.rotation_resolution, cfg.rlbench.episode_length,
                create_language_model("stub"))
    ex = fd.create_feature_extractor(nr.foundation_model_name,
                                     nr.foundation_checkpoint, device="cuda")
    agent = ManiGaussianBCAgent(cfg, device="cuda", seed=0)

    def plain(rgb):
        x = torch.as_tensor(np.asarray(rgb, np.float32)).cuda()
        return fd.extract_gt_embed(x, ex, nr.d_embed).cpu().numpy()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def own_stream(rgb):
        with torch.cuda.stream(side):
            return plain(rgb)

    fixed = None
    names = ("own_stream", "default_stream", "main_thread", "none")
    res = {n: {"step_ms": [], "wait_ms": [], "embed_wall_ms": [],
               "embed_cpu_ms": []} for n in names}

    def run(name: str) -> None:
        nonlocal fixed
        r = res[name]
        wall, cpu = [], []
        fn = {"own_stream": own_stream, "default_stream": plain}.get(name)
        it = BatchIterator(replay, cfg.replay.batch_size, seed=0,
                           num_view_for_nerf=m.num_view_for_nerf,
                           embed_fn=fn and timed_calls(fn, wall, cpu))
        inline = timed_calls(plain, wall, cpu)
        try:
            for i in range(2 + steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(it)
                t1 = time.perf_counter()
                if name == "main_thread":
                    batch["gt_embed"] = inline(batch["nerf_target_rgb"])
                elif name == "none":
                    if fixed is None:
                        fixed = plain(batch["nerf_target_rgb"])
                    batch["gt_embed"] = fixed
                loss = float(agent.update(
                    batch, torch.Generator().manual_seed(i))["total_loss"])
                t2 = time.perf_counter()
                if not np.isfinite(loss):
                    raise AssertionError(f"embed_ab {name}: loss {loss}")
                if i >= 2:
                    r["step_ms"].append((t2 - t0) * 1e3)
                    r["wait_ms"].append((t1 - t0) * 1e3)
        finally:
            it.close()
        r["embed_wall_ms"] += wall[2:]
        r["embed_cpu_ms"] += cpu[2:]

    for k in range(rounds):
        for name in (names if k % 2 == 0 else names[::-1]):
            run(name)
    out = {n: {**r, **{f"{key}_median": statistics.median(v)
                       for key, v in r.items() if v}}
           for n, r in res.items()}
    log("embed_ab", config="w_geo_sem_dyna", rounds=rounds,
        steps_per_round=steps, port_design="own_stream", designs=out, ok=True)
    del agent, ex
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv not in ([], ["--flash-times"], ["--blend-times"], ["--embed-ab"]):
        print(f"chip_smoke: unknown arguments {argv}; takes none, "
              "--flash-times, --blend-times or --embed-ab", file=sys.stderr)
        return 2
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
        from manigaussian_tpu_torch.ops.conv3d import (conv3d_dw_resident,
                                                       conv3d_dw_workspace,
                                                       conv3d_forward)
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
                "blend_fwd": blend_forward, "blend_bwd": blend_backward,
                "conv3d_fwd": conv3d_forward, "conv3d_dw": conv3d_dw_workspace,
                "conv3d_dw_resident": conv3d_dw_resident}

    if argv == ["--flash-times"]:
        # the flash kernels' times alone, for an A/B of two checkouts in one
        # call (run this file from the root of each in turn)
        phase_build()
        flash_times()
        return 0
    if argv == ["--blend-times"]:
        # the blend pair's times alone, for the same kind of A/B
        phase_build()
        blend_times()
        return 0
    if argv == ["--embed-ab"]:
        # where the semantic tiers' GT embedding runs, in one call
        phase_build()
        embed_ab()
        return 0
    t_start = time.time()
    phase_build()
    records = {**phase_flash(), **phase_blend(), **phase_conv()}
    bn = phase_bench(counters)
    phase_small()
    phase_small_train(counters)
    phase_sem_check()
    phase_clip_check()
    sl = phase_slice(counters)
    phase_routes(sl["cfg"], sl["logdir"], sl["demos"])
    tr = phase_train_slice(counters)
    phase_train_routes(
        tr["demos"], "train_routes", "w_geo", (),
        {"kernel": ({"policy_attn_impl": "flash"}, {"backend": "pallas"}),
         "plain": ({"policy_attn_impl": "xla"}, {"backend": "xla"})}, "kernel")
    dy = phase_tier_slice(counters, tr["demos"], "w_geo_dyna", DYNA_OVERRIDES,
                          "train_slice", "dyna_act")
    phase_train_routes(
        tr["demos"], "conv_routes", "w_geo_dyna",
        ("method.neural_renderer.next_mlp.warm_up=0",),
        {"pallas": ({"policy_conv_impl": "pallas"}, {}),
         "z2d": ({"policy_conv_impl": "z2d"}, {})}, "pallas")
    se = phase_tier_slice(counters, tr["demos"], "w_geo_sem_dyna",
                          SEM_OVERRIDES, "sem_slice", "sem_act")
    if se["extractors"] != ["SDVaeFeatureExtractor"] * 2:
        raise AssertionError(f"w_geo_sem_dyna built {se['extractors']}, not "
                             "the SD VAE")
    phase_train_routes(
        tr["demos"], "sem_routes", "w_geo_sem_dyna",
        (*SEM_OVERRIDES, "method.neural_renderer.next_mlp.warm_up=0"),
        {"kernel": ({"policy_attn_impl": "flash", "policy_conv_impl": "pallas"},
                    {"backend": "pallas"}),
         "plain": ({"policy_attn_impl": "xla", "policy_conv_impl": "z2d"},
                   {"backend": "xla"})}, "kernel")
    gn = phase_tier_slice(counters, tr["demos"], "w_geo", GNF_OVERRIDES,
                          "gnf_slice", "gnf_act")
    gr = phase_train_routes(
        tr["demos"], "gnf_routes", "w_geo", GNF_OVERRIDES,
        {"kernel": ({"policy_attn_impl": "flash"}, {}),
         "plain": ({"policy_attn_impl": "xla"}, {})}, "kernel", vis=True)
    phase_nerf_parts(gr["batch"], gr["cfg"])
    # launches on the main paths, each read just after its run: the full
    # model's training run (`launches`: w_geo_sem_dyna, the one path that
    # launches every kernel of the paths), and every path by name, the bench
    # and GNFACTOR_BC's among them (each phase holds its path to its
    # expected counts). A kernel of a path that the path never launched
    # fails the run; the resident dW scheme is on no path (the backward uses
    # the workspace scheme) and is held to its plain version and timed in
    # phase `conv` only.
    paths = {"act_w_geo": sl["launches"], "train_w_geo": tr["launches"],
             "train_w_geo_dyna": dy["launches"],
             "act_w_geo_dyna": dy["act_launches"],
             "train_w_geo_sem_dyna": se["launches"],
             "act_w_geo_sem_dyna": se["act_launches"],
             "bench": bn["launches"], "train_gnfactor_bc": gn["launches"],
             "act_gnfactor_bc": gn["act_launches"]}
    off_path = {"conv3d_dw_resident"}
    for name, rec in records.items():
        rec["launches"] = se["launches"][name]
        rec["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        if (rec["launches"] == 0) != (name in off_path):
            raise AssertionError(f"kernel {name}: {rec['launches']} launches "
                                 "on the main path")
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
    sys.exit(main(sys.argv[1:]))
