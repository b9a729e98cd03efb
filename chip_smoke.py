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
                   the forward with dropout on one rank's rows of a batch
                   (`bh_offset`) against the plain version there and the
                   whole batch's rows, bit for bit;
                   the tile blend forward and backward on the
                   tiles of real frames (16,384 random Gaussians in a 128²
                   view, binned by the port's rasterizer; batch 2; the micro
                   config's K 512 / chunk 32; empty tiles; 65,536
                   Gaussians at K 2048; the bench's own frame at K 8192 /
                   chunk 512), each bitwise repeatable; one rank's window
                   of the tile-sharded renderer (tiles 16-31 of the
                   training frame) against the plain version and the whole
                   frame's tiles, bit for bit; `golden`: the
                   JAX package's pinned frames (tests/goldens/*.npz, read with
                   numpy) rendered through the kernel route; `conv`: the 3³
                   conv forward, dx and dW (workspace and resident scheme, each
                   bitwise repeatable, and against each other; the resident
                   scheme in bf16 also at the widest cluster the card holds,
                   where small shapes leave CTAs without a step) in fp32 and
                   bf16 at ragged shapes and at the policy's two 100³ convs,
                   the resident scheme's plan (cluster size, clusters at
                   once, waves), with ptxas's registers and spill of the
                   three wgmma kernels.
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
 14. dino_dir    — the DINOv2 checkpoint-directory route: a tiny DINOv2
                   written as a Hugging Face directory by the port's writer,
                   loaded through `create_feature_extractor`, its features on
                   the card against the CPU.
 15. dp_slice    — multi-device training through `python -m
                   manigaussian_tpu_torch.train` at `w_geo` width, global
                   batch 2, 3 steps: one process; `--mesh 2` and
                   `--mesh-tile 2` (two ranks on the one card over gloo);
                   `--mesh 1` over NCCL. Each rank's launches, its
                   parameters equal to the others' bit for bit, the first
                   step's losses against the one-process run, step times
                   and peak memory (two ranks share one card: no scaling
                   figure).
 16. eval_slice  — the eval CLI at `w_geo` width over two checkpoints of
                   different weights: serially (the flash forward
                   `transformer_depth` times an act), with `--workers 2`
                   (two spawned processes on the card, each counting its
                   acts and launches; rows equal to the serial ones) and
                   with `--record-every-n 1` (a GIF an episode of its
                   steps + 1 frames); each run's wall time.
 17. eval_rpc    — `python -m manigaussian_tpu_torch.sim_host_server
                   --backend mock --port 0 --record <path>` in a
                   subprocess, the eval CLI against it (`--env rpc://`),
                   then the recorded session replayed (`--env
                   transcript://`, exhausted): the mock rows both times;
                   the time a step spends in the bridge.
 18. adam_slice  — `method.optimizer=adam` through the train entry point
                   (3 steps and a resume, as train_slice); the restored
                   optimizer state equal to the saved one bit for bit; one
                   more AdamW step on the card against the plain formula
                   in fp64 (`ADAM_TOL`); the step beside LAMB's.
 19. disk_slice  — the default `replay.use_disk=true` (the native record
                   store) through the train entry point, 3 steps and a
                   resume that reopens the log; the store must not have
                   fallen back to pickles; a pickle-layout run from the
                   same demos and seed gives the same first batches bit
                   for bit; both layouts' waits in `next(batches)`.
 20. two_level   — the rasterizer's `small_rect_cap` on the training frame
                   (16,384 Gaussians, 128², the blend kernels): bit for
                   bit the single-level render (image, features, T,
                   gradients) with a table of every big Gaussian; with a
                   quarter of them the CPU plain route's overflow count and
                   image; sort lengths and bin/sort times.
 21. dino_swiglu — the DINOv2 directory route with the SwiGLU MLP: a tiny
                   seeded SwiGLU DINOv2 written by `save_hf_dir`, loaded
                   through `create_feature_extractor`, card against CPU.
 22. towers_msgpack — CLIP text, DINOv2 and the SD VAE at tiny seeded
                   widths: the port's `tools/convert_weights` writes each
                   torch checkpoint as flax's `.msgpack`; each tower from
                   the `.msgpack` on the card equals the one from the
                   checkpoint bit for bit.
 23. imported_train — train_slice's demos exported in the reference's
                   on-disk layout (pickled Demo / Observation through module
                   shims, 24-bit depth PNGs, nerf_data), imported by `python
                   -m manigaussian_tpu_torch.tools.import_rlbench`, then
                   `w_geo` at full width for 3 steps and a resume through
                   the train entry point; the first step's losses beside
                   train_slice's.
 24. scaling     — `python -m manigaussian_tpu_torch.bench_scaling` as two
                   `--dist` ranks sharing the card over gloo (rank 0 in this
                   process): strong / weak render rows (65,536 Gaussians,
                   128²) and the tiny config's DP rows at D = 1 and D = 2
                   (`platform_limited`), the comm-model rows of the render
                   and of the `w_geo` DP step, each held to its reckoning.
 25. extras      — `knn_mean_sq_dist` at 16,384 points, `attention3d` and
                   `ssim`, card against CPU; `capture_trace` around one card
                   training step.
 26. campaign    — `python -m manigaussian_tpu_torch.scripts.flagship_campaign
                   --variant w_geo` through its main() at full `w_geo`
                   width and the campaign's data shapes (128², 21 nerf
                   views, 20-step episodes, 3 tasks), cut in depth only (2
                   demos a task, 60 iterations, log / save / render every
                   10 / 30 / 30): demo generation, the feed rate, training
                   (the flash and blend pairs), the artifact; no non-finite
                   cell, the JAX summary's keys, the last checkpoint
                   restored, the feed below the step.
 27. artifact    — `make_results_artifact.run` as the JAX miniature runs it
                   (1 seed, 2 tasks, 40 iterations, save every 20, 1
                   episode, 2 workers) on the card: the micro config's
                   training (the fp32 flash pair, 8-wide heads, and the
                   blend pair), two spawned eval workers on the card, the
                   reference CSV format.
 28. tools       — `gen_demonstrations` (one 128² episode),
                   `diagnose_learning` (40 micro iterations; training, then
                   the flash forward of every act) and `make_goldens` on the
                   card (its oracle, ops/rasterizer_ref.py) against
                   tests/goldens/*.npz, with the kernel route on the
                   regenerated scenes against them.
Every training slice also holds the recon render at step 0
(`render_for_vis`: the policy's forward, and one blend forward with the
splat renderer) to its launches.
Then one JSON line of kernel records, the card's name and power limit, and
last, the device line.

`python3 chip_smoke.py --flash-times` builds the kernels and prints only the
flash kernels' times (`flash_times`, through the public entry point): run
from the root of two checkouts in turn, it times both with one yardstick.
`--blend-times` does the same for the tile blend pair (`blend_times`,
through `blend_tiles` and autograd); `--conv-times` for the two dW
schemes beside conv3d_weight (`conv_times`, through `conv3d_dw_resident` and
`conv3d_dw_workspace`). `--gnf-steps` runs GNFACTOR_BC's first two steps
at full width on the card and on the CPU from the same weights and batch
(`gnf_steps`: loss heads, LAMB's trust ratios by leaf, the first update
split by leaf group). `--embed-ab` builds the kernels and
compares where the SD VAE's ground-truth embedding runs in `w_geo_sem_dyna`
training (`embed_ab`: its prefetch thread on a stream of its own or on the
default stream, the main thread, or no tower). `--step-times` times the
one-process `w_geo` step and act at full width through `create_agent`,
`update` and `act` only (`step_times`), for the same kind of A/B.

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


def flash_offset_check() -> dict:
    """The flash forward on one rank's rows of a data-parallel batch: q, k,
    v of rows 2-3 of a batch of 4 at [·, 8, 2048, 64] bf16 (and [·, 8, 512,
    64] fp32), dropout 0.1, `bh_offset` = 2·8. The rank's output (and in
    bf16 its keep bits) equals rows 2-3 of the kernel's call on the whole
    batch bit for bit, and the plain version at the same offset within row
    1's tolerance; in fp32, whose backward hashes the mask again, the rank's
    dq, dk, dv equal the whole batch's rows bit for bit too."""
    import torch
    from manigaussian_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_self_attention_backward,
        flash_self_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for dtype, n, tol in (("bfloat16", 2048, 2e-2), ("float32", 512, 1e-5)):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(4, 8, n, 64, generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        g = torch.randn(4, 8, n, 64, generator=gen, device="cuda").to(dt)
        seed, rate, lo = 4321, 0.1, 2
        whole, lse_w, bits_w = flash_attention_forward(q, k, v, rate, seed, 256,
                                                       with_lse=True)
        qr, kr, vr = (x[lo:].contiguous() for x in (q, k, v))
        part, lse_p, bits_p = flash_attention_forward(qr, kr, vr, rate, seed,
                                                      256, with_lse=True,
                                                      bh_offset=lo * 8)
        ref = flash_self_attention_reference(qr, kr, vr, rate, seed, 256,
                                             bh_offset=lo * 8)
        rows_equal = torch.equal(part, whole[lo:])
        bits_equal = (bits_p is None and bits_w is None) or torch.equal(
            bits_p, bits_w[lo * 8:])
        err = (part.float() - ref.float()).abs().max().item()
        extra = {}
        if dtype == "float32":
            gw = flash_self_attention_backward(q, k, v, whole, g, lse_w, rate,
                                               seed, 256)
            gp = flash_self_attention_backward(
                qr, kr, vr, part, g[lo:].contiguous(), lse_p, rate, seed, 256,
                bh_offset=lo * 8)
            extra["bwd_rows_bitwise_equal"] = all(
                torch.equal(a[lo:], b) for a, b in zip(gw, gp))
        torch.cuda.synchronize()
        ok = rows_equal and bits_equal and err <= tol and all(extra.values())
        log("kernel_check", kernel="flash_self_attention_bh_offset",
            dtype=dtype, shape=[2, 8, n, 64], rows_of=[4, 8, n, 64],
            bh_offset=lo * 8, dropout=rate, rows_bitwise_equal=rows_equal,
            keep_bits_equal=bits_equal, max_abs_err=err, tol=tol, **extra,
            ok=ok)
        if not ok:
            raise AssertionError(f"flash bh_offset check failed ({dtype}): "
                                 f"rows {rows_equal} bits {bits_equal} err "
                                 f"{err} {extra}")
        out[dtype] = err
    return out


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
    flash_offset_check()
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


def random_frame(n: int = 16384, hw: int = 128, seed: int = 0,
                 tile_range=None):
    """A real frame's blend inputs: n random Gaussians (the JAX tests'
    random_scene distribution, drawn with numpy) in front of a 128² camera,
    binned and packed by the port's rasterizer on the card (only the tiles
    of `tile_range`, a rank's window, when given)."""
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
    gidx, in_list, _, ov_s, ov_g = tile_lists(pre, cfg, tile_range)
    with torch.no_grad():
        counts, origins, attrs, livet = pack_tiles(pre, t(lang), gidx, in_list,
                                                   cfg, 1, tile_range)
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


def blend_window_check() -> None:
    """The blend pair on one rank's window of the tile-sharded renderer:
    tiles 16-31 of the 64-tile training frame (16,384 Gaussians, 128²),
    binned and packed with `tile_range` (global pixel origins). The kernels'
    outputs and the gradient of the window's attributes equal the same
    tiles of the whole frame's kernel calls bit for bit, and the plain
    version under the golden rules."""
    import torch
    from manigaussian_tpu_torch.ops.blend import (blend_tiles,
                                                  blend_tiles_reference)
    gen = torch.Generator(device="cuda").manual_seed(5)
    whole = random_frame(16384, 128, 0)[:4]
    part = random_frame(16384, 128, 0, tile_range=(16, 16))[:4]
    gs = [torch.randn(64, c, 256, generator=gen, device="cuda") for c in (3, 3, 1)]
    gw = [g[16:32] for g in gs]

    def run(fn, frame, grads):
        a = frame[2].clone().requires_grad_()
        out = fn(frame[0], frame[1], a, frame[3], 3, 16, 256)
        sum((o * g).sum() for o, g in zip(out, grads)).backward()
        return [o.detach() for o in out], a.grad

    out_w, grad_w = run(blend_tiles, whole, gs)
    out_p, grad_p = run(blend_tiles, part, gw)
    ref_p, rgrad_p = run(blend_tiles_reference, part, gw)
    torch.cuda.synchronize()
    # the packed inputs alike on the live slots (a slot past a tile's list
    # holds whatever follows it in the sorted keys, which the window cuts)
    live = whole[3][16:32] > 0.5
    inputs_equal = (all(torch.equal(a, b[16:32]) for a, b in
                        zip((part[0], part[1], part[3]),
                            (whole[0], whole[1], whole[3])))
                    and torch.equal(torch.where(live, part[2], 0.0),
                                    torch.where(live, whole[2][16:32], 0.0)))
    tiles_equal = all(torch.equal(a, b[16:32]) for a, b in zip(out_p, out_w))
    grad_equal = torch.equal(grad_p, grad_w[16:32])
    fwd = [mostly_close(o.cpu(), r.cpu(), 1e-4, 1e-3) for o, r in zip(out_p, ref_p)]
    bwd = mostly_close(grad_p.cpu(), rgrad_p.cpu(), 2e-4, 1e-3, 0.02)
    ok = (inputs_equal and tiles_equal and grad_equal and bwd[0]
          and all(x[0] for x in fwd))
    log("kernel_check", kernel="blend_tiles_window", frame="train_16384",
        window=[16, 32], tiles=int(part[0].shape[0]),
        origins_first=part[1][0].tolist(),
        packed_live_slots_equal_whole=inputs_equal,
        outputs_bitwise_equal_whole=tiles_equal,
        dattrs_bitwise_equal_whole=grad_equal,
        fwd_frac_outside_max_diff=[x[1:] for x in fwd],
        bwd_frac_outside_max_diff=bwd[1:], ok=ok)
    if not ok:
        raise AssertionError(f"blend window check failed: packed "
                             f"{inputs_equal} outputs {tiles_equal} grads "
                             f"{grad_equal} fwd {fwd} bwd {bwd}")


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
    blend_window_check()
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
    samples at 128 → 128 channels, 128 ↔ 256 channels for a forward and a
    dx over two 128-wide tiles, Ci and Co off the tile widths, and 27 voxels
    whose one step leaves all but one CTA of a cluster without a step) and
    at the policy's two 100³ convs in bf16; the two dW schemes, two
    independent sums, against each other, and each bitwise equal across two
    runs; in bf16 the resident scheme also at the largest cluster the card
    holds, where the small shapes give CTAs no step; the resident scheme's
    plan (cluster size, clusters at once, waves) at each shape; ptxas's
    registers and spill of the three wgmma kernels (no spill, no serialized
    wgmma); then the time of each kernel, of its plain version and of the
    library call (F.conv3d, conv3d_weight: a yardstick only) beside its
    bound."""
    import torch
    import torch.nn.functional as F
    from manigaussian_tpu_torch.ops.conv3d import (conv3d_dw_reference,
                                                   conv3d_dw_resident,
                                                   conv3d_dw_resident_cluster,
                                                   conv3d_dw_workspace,
                                                   conv3d_forward,
                                                   conv3d_same_reference,
                                                   dw_resident_plan,
                                                   resident_clusters)

    gen = torch.Generator(device="cuda").manual_seed(2)
    rel = lambda got, ref: ((got.float() - ref).abs().max()
                            / max(1.0, ref.abs().max().item())).item()
    table = resident_clusters(torch.device("cuda"))
    widest = max(s for s, held in table.items() if held > 0)
    log("dw_resident_clusters", clusters_at_once_by_size=table,
        widest=widest)

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
        dw_fns = [("dw_workspace", conv3d_dw_workspace),
                  ("dw_resident", conv3d_dw_resident)]
        plan = None
        if dtype == "bfloat16":
            plan = dw_resident_plan(b * d * h * w, ci, co, table)
            dw_fns.append((f"dw_resident_cluster_{widest}",
                           lambda x, dy: conv3d_dw_resident_cluster(x, dy,
                                                                    widest)))
        for name, fn in dw_fns:
            got[name] = fn(x, dy)
            errs[name] = rel(got[name], ref)
            same[name] = torch.equal(fn(x, dy), got[name])
        # kernel against kernel: each is within tol of the plain version
        for name in got:
            if name != "dw_workspace":
                errs[f"dw_workspace_vs_{name[3:]}"] = rel(got["dw_workspace"],
                                                         got[name])
        torch.cuda.synchronize()
        tol = CONV_TOL[dtype]
        ok = (errs["fwd"] <= tol["fwd"] and errs["dx"] <= tol["fwd"]
              and all(errs[n] <= tol["dw"] for n in got)
              and all(v <= 2 * tol["dw"] for k, v in errs.items()
                      if k.startswith("dw_workspace_vs_"))
              and all(same.values()))
        log("kernel_check", kernel="conv3d", conv=label, dtype=dtype,
            shape=[b, d, h, w, ci], co=co, compared_with="the plain version",
            err_over_scale=errs, tol=tol, bitwise_repeatable=same,
            resident_plan=plan, ok=ok)
        if not ok:
            raise AssertionError(f"conv kernels disagree ({label}, {dtype}): "
                                 f"{errs} {same}")
        return x, wm, dy, errs, y_scale, max(1.0, ref.abs().max().item()), plan

    for shape in ((1, 5, 6, 7, 8, 16), (2, 9, 10, 11, 24, 40),
                  (1, 12, 13, 14, 72, 136), (2, 12, 13, 14, 128, 128),
                  (1, 6, 7, 9, 128, 256), (1, 6, 7, 9, 256, 128),
                  (1, 3, 3, 3, 64, 128)):
        for dtype in ("float32", "bfloat16"):
            check("ragged", dtype, *shape)

    build = {"conv3d_fwd": ptxas_report("conv3d", "conv3d_fwd_wgmma_kernel"),
             "conv3d_dw": ptxas_report("conv3d", "conv3d_dw_wgmma_kernel"),
             "conv3d_dw_resident": ptxas_report("conv3d",
                                                "conv3d_dw_resident_kernel")}
    log("kernel_build", source="manigaussian_tpu_torch/csrc/conv3d.cu", **build)
    if any(b["spill_bytes"] or b["wgmma_serialized"] for b in build.values()):
        raise AssertionError(f"the wgmma conv kernels spill or serialize: {build}")

    records = {}
    for label, ci, co in (("final 256→128", 256, 128),
                          ("up0 post-resize 128→128", 128, 128)):
        x, wm, dy, errs, y_scale, dw_scale, plan = check(
            label, "bfloat16", 1, 100, 100, 100, ci, co)
        log("dw_resident_plan", conv=label, shape=[1, 100, 100, 100, ci],
            co=co, **plan)
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
            # the device reading beside the host loop's: summed kernel
            # durations, without the gaps between launches
            times["device_ms"] = device_ms(fns["ms"], iters=10, warmup=2)
            times["library_device_ms"] = device_ms(fns["library_ms"],
                                                   iters=10, warmup=2)
            bound_ms, bound_by = bound(flops, nbytes[kind], PEAK_FLOPS["bfloat16"])
            extra = ({k: plan[k] for k in ("cluster", "clusters_at_once",
                                            "waves", "steps_per_cta")}
                     if name == "conv3d_dw_resident" else {})
            log("kernel_time", kernel=name, conv=label,
                shape=[1, 100, 100, 100, ci], co=co, dtype="bfloat16",
                flops=flops, bytes=nbytes[kind], **times, bound_ms=bound_ms,
                bound_by=bound_by, tflops=flops / times["ms"] / 1e9,
                factor_vs_bound=times["ms"] / bound_ms,
                factor_vs_library=times["ms"] / times["library_ms"],
                **extra, **build.get(name, {}))
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
                    "shape": f"[1,100,100,100,{ci}] -> {co}, bfloat16", **extra}
            else:
                records[name]["up0_128_to_128"] = {**times, "bound_ms": bound_ms,
                                                   **extra}
        del x, wm, dy, xl, gl, wl, w_flip, cases, fns, lib_dw
        torch.cuda.empty_cache()
    return records


def conv_times(rounds: int = 2) -> dict:
    """The dW kernels' device time alone (`device_ms`, and the host loop's
    reading beside it) at the policy's two 100³ convs in bf16: the resident
    scheme, the workspace scheme (with its reduction) and conv3d_weight (a
    yardstick), read in alternation, `rounds` times each, through the
    public entry points only, so that the same file times an older checkout
    (run it from the root of each)."""
    import torch
    from manigaussian_tpu_torch.ops.conv3d import (conv3d_dw_resident,
                                                   conv3d_dw_workspace)
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for label, ci, co in (("final 256→128", 256, 128),
                          ("up0 post-resize 128→128", 128, 128)):
        x = torch.randn(1, 100, 100, 100, ci, generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(1, 100, 100, 100, co, generator=gen,
                         device="cuda").to(torch.bfloat16)
        xl, gl = (t.permute(0, 4, 1, 2, 3) for t in (x, dy))
        shape = (co, ci, 3, 3, 3)
        fns = {"resident": lambda: conv3d_dw_resident(x, dy),
               "workspace": lambda: conv3d_dw_workspace(x, dy),
               "conv3d_weight": lambda: torch.nn.grad.conv3d_weight(
                   xl, shape, gl, padding=1)}
        times = {k: [] for k in fns}
        host = {k: [] for k in fns}
        for r in range(rounds):
            for k in (fns if r % 2 == 0 else list(fns)[::-1]):
                times[k].append(device_ms(fns[k], iters=10, warmup=2))
                host[k].append(cuda_ms(fns[k], iters=10, warmup=2))
        out[label] = times
        log("conv_times", conv=label, shape=[1, 100, 100, 100, ci], co=co,
            dtype="bfloat16", device_ms=times, host_loop_ms=host,
            resident_over_library=[a / b for a, b in
                                   zip(times["resident"], times["conv3d_weight"])])
        del x, dy, xl, gl, fns
        torch.cuda.empty_cache()
    return out


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


ACT_ARGS = ("--env", "mock", "--eval-type", "last", "--episodes", "2",
            "--episode-length", "5")


def drive_eval(counters: dict, logdir: str, demos: str, args=ACT_ARGS):
    """The port's eval entry point (by default on the mock env from the
    newest checkpoint under `logdir`; `args` its flags after --logdir and
    --demo-root), with the counts set to 0 just before and read just after.
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
                              *args])
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
    logdir = os.path.join(WORK, f"train_logs_{label}_{variant}_{m.name}")
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

    def watched_render(self, params, cameras, tile_mesh=None):
        out = orig_render(self, params, cameras, tile_mesh)
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
            "extractors": extractors, "peak": peak,
            "losses_first": metrics_seen[0]}


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


def step_times(steps: int = 12, acts: int = 14) -> dict:
    """The one-process `w_geo` training step and act at full width, batch 1,
    through `create_agent`, `update` and `act` only (the public path, the
    same in older checkouts), host clock around calls that end in a
    device→host copy or a synchronize; medians after 2 steps / 4 acts. For
    an A/B of two checkouts in one call (parent, change, change, parent)."""
    import statistics

    import numpy as np
    import torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    agent = create_agent(train_config("w_geo"), device="cuda", seed=0)
    rng = np.random.default_rng(0)
    f, b, hw = np.float32, 1, 128
    batch = {
        "rgb": rng.uniform(size=(b, 1, hw, hw, 3)).astype(f),
        "pcd": (np.array([0.2, 0.0, 1.1]) + np.array([0.25, 0.35, 0.1])
                * rng.standard_normal((b, 1, hw, hw, 3))).astype(f),
        "low_dim_state": rng.standard_normal((b, 4)).astype(f),
        "lang_goal_emb": (0.1 * rng.standard_normal((b, 1024))).astype(f),
        "lang_token_embs": (0.1 * rng.standard_normal((b, 77, 512))).astype(f),
        "trans_action_indicies": np.array([[50, 40, 60]] * b, np.int32),
        "rot_grip_action_indicies": np.array([[10, 20, 30, 1]] * b, np.int32),
        "ignore_collisions": np.ones((b, 1), np.int32),
        "gripper_pose": np.tile(np.array([0.2, 0, 1.1, 0, 0, 0, 1.0], f), (b, 1)),
        "action": np.zeros((b, 8), f),
        "nerf_target_rgb": rng.uniform(size=(b, hw, hw, 3)).astype(f),
        "nerf_target_pose": np.tile(np.eye(4, dtype=f), (b, 1, 1)),
        "nerf_target_intrinsic": np.tile(np.array(
            [[110.0, 0, 64], [0, 110.0, 64], [0, 0, 1]], f), (b, 1, 1)),
    }
    gen = torch.Generator().manual_seed(1)
    step_ms, act_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(agent.update(batch, gen)["total_loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    obs = {k: batch[k] for k in ("rgb", "pcd", "low_dim_state",
                                 "lang_goal_emb", "lang_token_embs")}
    for _ in range(acts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.act(obs)
        torch.cuda.synchronize()
        act_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms_median": statistics.median(step_ms[2:]),
           "act_ms_median": statistics.median(act_ms[4:]),
           "step_ms": step_ms, "act_ms": act_ms}
    log("step_times", config="w_geo", batch=1, tree=ROOT, **out)
    return out


DINO_TOL = 1e-4


def phase_dino_dir() -> dict:
    """The DINOv2 checkpoint-directory route: a tiny DINOv2 (patch 14, width
    64, 2 layers, a 5² position grid) with seeded random weights, written as
    a Hugging Face directory by the port's own writer (`save_hf_dir`:
    config.json, preprocessor_config.json, model.safetensors), loaded through
    `create_feature_extractor("dinov2", <dir>)` on the card and on the CPU;
    the features of two 128² views (resized to 112, cropped to 98: a 7²
    patch grid, the position grid resized bicubically) agree within
    DINO_TOL of their scale (fp32, TF32 off)."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.models.dinov2 import (DinoV2DirExtractor,
                                                      DinoV2ViT, save_hf_dir)
    from manigaussian_tpu_torch.models.foundation import \
        create_feature_extractor
    gen = torch.Generator().manual_seed(0)
    model = DinoV2ViT(patch_size=14, width=64, layers=2, heads=2, pos_grid=5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if name.endswith("norm1.weight") or name.endswith(
                "norm2.weight") or name == "norm.weight" else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
    path = os.path.join(WORK, "dinov2_dir")
    save_hf_dir(path, model, size={"shortest_edge": 112},
                crop_size={"height": 98, "width": 98})
    rgb = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, 128, 128, 3)).astype(np.float32))
    card = create_feature_extractor("dinov2", path, device="cuda")
    cpu = create_feature_extractor("dinov2", path, device="cpu")
    if not (isinstance(card, DinoV2DirExtractor)
            and isinstance(cpu, DinoV2DirExtractor)):
        raise AssertionError("the DINOv2 directory did not load as one")
    fc = card(rgb.cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fc = card(rgb.cuda())
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    fp = cpu(rgb)
    scale = float(fp.abs().max())
    err = float((fc.cpu() - fp).abs().max())
    ok = (tuple(fc.shape) == (2, 128, 128, 64) and bool(torch.isfinite(fc).all())
          and err <= DINO_TOL * max(1.0, scale))
    log("dino_dir", files=sorted(os.listdir(path)), shape=list(fc.shape),
        max_abs_err_card_vs_cpu=err, scale=scale, tol=DINO_TOL,
        call_ms=call_ms, ok=ok)
    if not ok:
        raise AssertionError(f"dino_dir: card against CPU {err} (scale "
                             f"{scale}), shape {tuple(fc.shape)}")
    return {"max_abs_err": err}


# The multi-device runs of `dp_slice` (w_geo at full width, global batch 2,
# DP_STEPS steps), each through `python -m manigaussian_tpu_torch.train`:
# one process; `--mesh 2` and `--mesh-tile 2`, two ranks on the one card
# over gloo (NCCL refuses two ranks on one GPU); `--mesh 1` over NCCL.
DP_RUNS = (("one_process", []),
           ("mesh2_gloo", ["--mesh", "2", "--backend", "gloo"]),
           ("mesh_tile2_gloo", ["--mesh-tile", "2", "--backend", "gloo"]),
           ("mesh1_nccl", ["--mesh", "1"]))
DP_STEPS = 3
# first-step losses of a sharded run against the one-process run, relative
# to max(1, |x|): bf16 policy matmuls on other row counts. Set from the first
# run on the card (NVIDIA H100 80GB HBM3, 700.00 W): the worst head was
# collision_loss at 9.6e-3 (--mesh 2); the tile-sharded run's first step
# equalled the one-process run's bit for bit
DP_TOL = 2e-2
DP_HEADS = ("total_loss", "bc_loss", "trans_loss", "rot_loss", "grip_loss",
            "collision_loss", "rgb_loss", "psnr")


def run_cli(args, timeout: float):
    """`python <args>` from the repository root in a session of its own;
    on a timeout the whole session (the CLI's worker processes too) is
    killed. Returns (returncode, stdout, stderr)."""
    import signal
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{args} ran past {timeout} s:\n{out[-2000:]}"
                             f"\n{err[-2000:]}")
    return proc.returncode, out, err


def run_lines(out: str) -> list:
    """The `[train] run {...}` JSON objects in a CLI's output (ranks share
    the stream, so a line may hold two)."""
    dec, tag, found, at = json.JSONDecoder(), "[train] run ", [], 0
    while (at := out.find(tag, at)) >= 0:
        obj, end = dec.raw_decode(out, at + len(tag))
        found.append(obj)
        at = end
    return found


def phase_dp_slice(demos: str) -> dict:
    """Multi-device training through the train entry point (`DP_RUNS`): every
    run's CSV finite; every rank's kernel launches exactly a step's
    (`expected_launches`, the flash and blend kernels: a tile rank blends its
    window of 32 tiles, one launch each way) times DP_STEPS, plus the recon
    render's on rank 0; every rank's parameters equal to the others' bit for
    bit after the last step; the first step's losses of each sharded run
    within DP_TOL of the one-process run's. Logged: each run's step time
    (its CSV's last step), each rank's peak memory, the backend, the card's
    name and power limit. Two ranks share one card here: these times are
    not a scaling figure."""
    import csv
    import numpy as np
    cfg = train_config("w_geo")
    m = cfg.method
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    base = ["-m", "manigaussian_tpu_torch.train", "--variant", "w_geo",
            "--demo-root", demos, *TRAIN_OVERRIDES, "replay.batch_size=2",
            f"framework.training_iterations={DP_STEPS}"]
    step = {}
    for s in range(DP_STEPS):
        for k, v in expected_launches(m, s).items():
            step[k] = step.get(k, 0) + v
    vis = expected_vis_launches(m)
    runs, launches_by_run = {}, {}
    for name, flags in DP_RUNS:
        logdir = os.path.join(WORK, f"dp_{name}")
        t0 = time.time()
        rc, out, err = run_cli([*base, "--logdir", logdir, *flags], 900)
        wall = time.time() - t0
        if rc:
            raise AssertionError(f"dp_slice {name}: exit {rc}\n{out[-3000:]}"
                                 f"\n{err[-3000:]}")
        ranks = sorted(run_lines(out), key=lambda r: r["rank"])
        with open(os.path.join(logdir, "seed0", "train_data.csv")) as f:
            rows = list(csv.DictReader(f))
        world = ranks[0]["world"] if ranks else 0
        expect = [{k: step[k] + (vis[k] if r == 0 else 0) for k in step}
                  for r in range(world)]
        got = [r["kernel_launches"] for r in ranks]
        finite = all(np.isfinite(float(v)) for row in rows for v in row.values())
        runs[name] = {
            "world": world, "backend": ranks[0]["backend"] if ranks else None,
            "first_step": {k: float(rows[0][k]) for k in DP_HEADS},
            "step_ms": [1e3 / float(r["steps_per_s"]) for r in rows[1:]],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "params_equal_across_ranks": [r["params_equal_across_ranks"]
                                          for r in ranks],
            "launches": got, "wall_s": wall}
        launches_by_run[name] = got[0] if got else {}
        ok = (len(ranks) == world >= 1 and len(rows) == DP_STEPS and finite
              and got == expect
              and all(r["params_equal_across_ranks"] is not False
                      for r in ranks)
              and (world == 1 or all(r["params_equal_across_ranks"]
                                     for r in ranks)))
        log("dp_slice", run=name, flags=flags, card=smi, **runs[name],
            expected_launches=expect, csv_rows=len(rows), finite=finite, ok=ok)
        if not ok:
            raise AssertionError(f"dp_slice {name}: {runs[name]}, expected "
                                 f"launches {expect}, rows {len(rows)}, "
                                 f"finite {finite}\n{out[-2000:]}")
    ref = runs["one_process"]["first_step"]
    diffs = {name: {k: abs(r["first_step"][k] - ref[k]) / max(1.0, abs(ref[k]))
                    for k in DP_HEADS}
             for name, r in runs.items() if name != "one_process"}
    worst = max(max(d.values()) for d in diffs.values())
    ok = worst <= DP_TOL
    log("dp_slice", check="first_step_losses_vs_one_process", card=smi,
        rel_diff=diffs, worst=worst, tol=DP_TOL,
        rule="|x − x_one| ≤ tol·max(1, |x_one|)", ok=ok)
    if not ok:
        raise AssertionError(f"dp_slice: first-step losses off by {worst}: "
                             f"{diffs}")
    return {"launches": launches_by_run, "runs": runs}


def gnf_steps(devices=("cuda", "cpu"), steps: int = 2) -> dict:
    """GNFACTOR_BC at `gnf_slice`'s width: the same seeded weights and the
    same first batch through `update` on each of `devices` (the kernels on
    the card, the plain versions on the CPU), dropout 0, the same
    augmentation and NeRF draws, `steps` steps on that batch. Logs each
    step's loss heads, per LAMB leaf of each update the trust ratio
    (|Δp| / (lr·|u|), u rebuilt from the moments the step left) and the
    relative change |Δp| / |p| of the leaves that moved most, the scale of
    the voxel features each NeRF call reads, and the losses with the first
    update applied to one group of leaves only (the NeRF MLP's
    zero-initialized fc1 weights, the rest of the NeRF, the policy)."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import assemble_batch, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    from manigaussian_tpu_torch.data.synthetic import generate_task
    from manigaussian_tpu_torch.ops.augmentation import sample_se3_draws
    from manigaussian_tpu_torch.rendering.nerf_renderer import \
        GNFactorNeRFRenderer

    cfg = train_config("w_geo", GNF_OVERRIDES)
    cfg = dataclasses.replace(cfg, method=dataclasses.replace(
        cfg.method, input_dropout=0.0, attn_dropout=0.0))
    m = cfg.method
    demos = os.path.join(WORK, "gnf_step_demos")
    generate_task(demos, TASK, num_episodes=2, timesteps=16,
                  h=cfg.rlbench.camera_resolution[0],
                  w=cfg.rlbench.camera_resolution[1], nerf_views=3,
                  nerf_hw=m.neural_renderer.image_height)
    replay = TaskUniformReplay()
    fill_replay(replay, demos, TASK, 2, cfg.rlbench.cameras,
                cfg.rlbench.scene_bounds, m.voxel_sizes[0],
                m.rotation_resolution, cfg.rlbench.episode_length,
                create_language_model("stub"))
    rng = np.random.default_rng(0)
    batch = assemble_batch(replay.sample(1, rng), rng, m.num_view_for_nerf)
    draws = sample_se3_draws(torch.Generator().manual_seed(5), 1, m.aug_rpy,
                             m.rotation_resolution)
    heads = ("total_loss", "bc_loss", "rgb_loss", "embed_loss", "psnr")
    feats = []          # the voxel features each NeRF call sees

    def run(dev):
        agent = create_agent(cfg, device=dev, seed=0)
        names = [n for n, _ in agent.qfn.named_parameters()]
        rows = []
        for i in range(steps):
            opt = agent.optimizer()
            before = [p.detach().clone() for p in opt.params]
            t0 = time.perf_counter()
            res = agent.update(batch, torch.Generator().manual_seed(i),
                               draws=draws)
            row = {k: float(res[k]) for k in heads}
            row["step_s"] = time.perf_counter() - t0
            lr = opt.lr(opt.count - 1) if callable(opt.lr) else opt.lr
            leaves = []
            with torch.no_grad():
                for n, p0, p, mu, nu in zip(names, before, opt.params, opt.mu,
                                            opt.nu):
                    u = mu / (torch.sqrt(nu) + opt.eps) + opt.weight_decay * p0
                    dp = float(torch.linalg.norm((p - p0).float()))
                    un = float(torch.linalg.norm(u.float()))
                    pn = float(torch.linalg.norm(p0.float()))
                    leaves.append({"leaf": n, "w_norm": pn, "trust":
                                   dp / (lr * un) if un > 0 else None,
                                   "rel_change": dp / pn if pn > 0 else None,
                                   "abs_change": dp})
            leaves.sort(key=lambda r: -r["abs_change"])
            row["zero_init_leaves"] = [r for r in leaves
                                       if r["w_norm"] == 0 and r["abs_change"]]
            row["top_abs_change"] = leaves[:12]
            rows.append(row)
            log("gnf_step", device=dev, step=i, **row)
            if i == 0:
                first = (before, [p.detach().clone() for p in opt.params])
        # the first update split by leaf group: the loss at the seeded
        # weights with only that group's update applied (`update` reports
        # the loss of the weights it starts from)
        groups = {"nerf_fc1": lambda n: "nerf.mlp" in n and ".fc1." in n,
                  "nerf_other": lambda n: (n.startswith("neural_renderer.")
                                           and not ("nerf.mlp" in n
                                                    and ".fc1." in n)),
                  "policy": lambda n: not n.startswith("neural_renderer.")}
        ablation = {}
        for group, member in groups.items():
            with torch.no_grad():
                for n, p, p0, p1 in zip(names, opt.params, *first):
                    p.copy_(p1 if member(n) else p0)
            res = agent.update(batch, torch.Generator().manual_seed(1),
                               draws=draws)
            ablation[group] = {k: float(res[k]) for k in heads}
        log("gnf_ablation", device=dev, loss_after_first_update_of=ablation)
        del agent
        if dev == "cuda":
            torch.cuda.empty_cache()
        return rows

    orig_forward = GNFactorNeRFRenderer.forward

    def watched_forward(self, voxel_feat, *args, **kwargs):
        v = voxel_feat.detach().float()
        feats.append({"shape": list(v.shape), "mean_abs": float(v.abs().mean()),
                      "std": float(v.std()), "max_abs": float(v.abs().max())})
        return orig_forward(self, voxel_feat, *args, **kwargs)

    GNFactorNeRFRenderer.forward = watched_forward
    try:
        out = {dev: run(dev) for dev in devices}
    finally:
        GNFactorNeRFRenderer.forward = orig_forward
    log("gnf_steps", config="w_geo", overrides=GNF_OVERRIDES,
        devices=list(devices), steps=steps,
        rgb_loss={dev: [r["rgb_loss"] for r in rows] for dev, rows in out.items()},
        total_loss={dev: [r["total_loss"] for r in rows]
                    for dev, rows in out.items()},
        nerf_voxel_features=feats, ok=True)
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


# ---------------------------------------------------------------- slice 11
# The eval CLI's checkpoint workers, GIFs and RPC / transcript envs; Adam;
# the native replay store; the rasterizer's two-level duplication.
EVAL_ARGS = ("--eval-type", "missing", "--episodes", "2",
             "--episode-length", "5")


class timed_methods:
    """Within the block, each (class, name) method appends its calls' wall
    ms to `self.ms[name]`."""

    def __init__(self, *methods):
        self.methods, self.ms, self._orig = methods, {}, []

    def __enter__(self):
        for cls, name in self.methods:
            orig = getattr(cls, name)
            times = self.ms.setdefault(f"{cls.__name__}.{name}", [])

            def timed(*args, _orig=orig, _times=times, **kwargs):
                t0 = time.perf_counter()
                out = _orig(*args, **kwargs)
                _times.append((time.perf_counter() - t0) * 1e3)
                return out

            self._orig.append((cls, name, orig))
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._orig:
            setattr(cls, name, orig)


def counted_eval_worker(job):
    """One checkpoint's eval in a spawned worker of `eval --workers`: the
    runner's worker function and its payload (`job`), with the worker's act
    calls, kernel launches and card written to <WORK>/eval_workers/<step>.json
    for the parent to check."""
    import torch
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.train import kernel_launches
    fn, payload = job
    calls, orig = [0], ManiGaussianBCAgent.act

    def counted(self, observation):
        calls[0] += 1
        return orig(self, observation)

    ManiGaussianBCAgent.act = counted
    t0 = time.time()
    row = fn(payload)
    on_card = torch.cuda.is_initialized()
    if on_card:
        torch.cuda.synchronize()
    out = os.path.join(WORK, "eval_workers")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{payload[2]}.json"), "w") as f:
        json.dump({"pid": os.getpid(), "device": payload[6],
                   "card": torch.cuda.get_device_name(0) if on_card else None,
                   "act_calls": calls[0], "launches": kernel_launches(),
                   "seconds": time.time() - t0}, f)
    return row


class _CountedPool:
    """The spawn pool of `run_eval_parallel`, each task run through
    `counted_eval_worker`."""

    def __init__(self, pool):
        self.pool = pool

    def __enter__(self):
        self.pool.__enter__()
        return self

    def __exit__(self, *exc):
        return self.pool.__exit__(*exc)

    def map(self, fn, payloads):
        return self.pool.map(counted_eval_worker, [(fn, p) for p in payloads])


def eval_copy(src: str, name: str) -> str:
    """A log dir's checkpoints and config without its CSV, videos and
    language cache, under WORK/<name>."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "eval_data.csv", "videos", "lang_cache"))
    return dst


def phase_eval_slice(counters: dict, sl: dict) -> dict:
    """The eval CLI at full `w_geo` width over two checkpoints of different
    weights (the slice's, seed 0, and one from seed 1): serially in this
    process with the launch counts (the flash forward `transformer_depth`
    times an act); with `--workers 2` (two spawned processes on the card,
    each counting its own acts and launches), whose rows must equal the
    serial ones; with `--record-every-n 1`, one GIF an episode holding the
    episode's steps + 1 frames. Each run's wall time."""
    import multiprocessing
    import torch
    from PIL import Image
    from manigaussian_tpu_torch import eval as eval_cli
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
    from manigaussian_tpu_torch.runners import eval_runner
    from manigaussian_tpu_torch.utils.checkpoint import save_checkpoint
    from manigaussian_tpu_torch.utils.video import EpisodeRecorder

    cfg, demos, m = sl["cfg"], sl["demos"], sl["cfg"].method
    base = eval_copy(sl["logdir"], "eval_ckpts")
    save_checkpoint(base, 1, create_agent(cfg, device="cuda", seed=1).qfn)
    t_phase = time.time()
    with timed_methods((MockEnvClient, "step")) as mock:
        calls, launches, rows, serial_s, act_ms = drive_eval(
            counters, eval_copy(base, "eval_serial"), demos,
            ("--env", "mock", *EVAL_ARGS))
    expect = {k: 0 for k in counters} | {
        "flash_self_attention_fwd": m.transformer_depth * calls}

    shutil.rmtree(os.path.join(WORK, "eval_workers"), ignore_errors=True)
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool
    ctx.Pool = lambda n: _CountedPool(pool(n))
    try:
        t0 = time.time()
        w_rows = eval_cli.main(["--logdir", eval_copy(base, "eval_workers_log"),
                                "--demo-root", demos, "--env", "mock",
                                *EVAL_ARGS, "--workers", "2"])
        workers_s = time.time() - t0
    finally:
        del ctx.Pool
    workers = {}
    for step in (0, 1):
        with open(os.path.join(WORK, "eval_workers", f"{step}.json")) as f:
            workers[step] = json.load(f)
    card = torch.cuda.get_device_name(0)
    workers_ok = all(
        w["device"] == "cuda" and w["card"] == card and w["act_calls"] > 0
        and w["launches"] == {k: 0 for k in counters} | {
            "flash_self_attention_fwd": m.transformer_depth * w["act_calls"]}
        for w in workers.values())
    worker_launches = {k: sum(w["launches"][k] for w in workers.values())
                       for k in counters}

    frames, lengths = [], []
    orig_save, orig_rollout = EpisodeRecorder.save, eval_runner.rollout_episode

    def counted_save(self, path_base, *args, **kwargs):
        frames.append((os.path.basename(path_base), len(self._frames)))
        return orig_save(self, path_base, *args, **kwargs)

    def counted_rollout(*args, **kwargs):
        out = orig_rollout(*args, **kwargs)
        lengths.append(out[1])
        return out

    EpisodeRecorder.save = counted_save
    eval_runner.rollout_episode = counted_rollout
    try:
        rec_log = eval_copy(base, "eval_record")
        t0 = time.time()
        r_rows = eval_cli.main(["--logdir", rec_log, "--demo-root", demos,
                                "--env", "mock", *EVAL_ARGS,
                                "--record-every-n", "1"])
        record_s = time.time() - t0
    finally:
        EpisodeRecorder.save = orig_save
        eval_runner.rollout_episode = orig_rollout
    task = cfg.rlbench.tasks[0]
    want = sorted(f"{task}_step{s}_ep{e}.gif" for s in (0, 1) for e in (0, 1))
    gifs = sorted(os.listdir(os.path.join(rec_log, "videos")))
    gif_frames = [Image.open(os.path.join(rec_log, "videos", g)).n_frames
                  for g in gifs]
    ok = (calls >= 4 and launches == expect and len(rows) == 2
          and [int(r["step"]) for r in rows] == [0, 1]
          and w_rows == rows and workers_ok and r_rows == rows
          and gifs == want and [n for _, n in frames] == [s + 1 for s in lengths]
          and all(0 < g <= s + 1 for g, s in zip(gif_frames, lengths)))
    log("eval_slice", config="w_geo", checkpoints=[0, 1], rows=rows,
        act_calls=calls, launches=launches, expected=expect,
        act_ms_median=statistics.median(act_ms),
        mock_step_ms_median=statistics.median(mock.ms["MockEnvClient.step"]),
        serial_s=serial_s, workers_s=workers_s, workers=workers,
        worker_rows_equal=w_rows == rows, record_s=record_s, gifs=gifs,
        recorder_frames=frames, episode_steps=lengths,
        gif_frames_after_pillow=gif_frames,
        seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError("the eval slice (workers, GIFs) failed its checks")
    return {"base": base, "rows": rows, "launches": launches,
            "worker_launches": worker_launches,
            "mock_step_ms": mock.ms["MockEnvClient.step"]}


def read_line(proc, timeout: float) -> str:
    """The next line of a subprocess's stdout, or an error after
    `timeout` seconds."""
    import select
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        raise AssertionError(f"no output from {proc.args} in {timeout} s")
    return proc.stdout.readline().strip()


def phase_eval_rpc(counters: dict, sl: dict, ev: dict) -> dict:
    """The eval CLI against a simulator on another process: `python -m
    manigaussian_tpu_torch.sim_host_server --backend mock --port 0` (its
    address read from its first line) recording the session, the CLI with
    `--env rpc://127.0.0.1:<port>`; then the recorded session replayed with
    `--env transcript://<path>`, which must end exhausted. Both give the
    serial mock run's rows, with the same launch counts; the time an env
    step takes through the bridge beside the in-process mock's."""
    from manigaussian_tpu_torch.envs.rpc import RPCEnvClient
    from manigaussian_tpu_torch.envs.transcript import TranscriptReplayEnv
    from manigaussian_tpu_torch.runners import eval_runner

    m = sl["cfg"].method
    session = os.path.join(WORK, "eval_rpc_session.jsonl")
    t_phase = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "manigaussian_tpu_torch.sim_host_server",
         "--host", "127.0.0.1", "--port", "0", "--backend", "mock",
         "--dataset-root", sl["demos"], "--episode-length", "5",
         "--record", session], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        line = read_line(proc, 120)
        address = line.rsplit(" ", 1)[-1]
        with timed_methods((RPCEnvClient, "step"),
                           (RPCEnvClient, "reset_to_demo")) as rpc:
            calls, launches, rows, rpc_s, _ = drive_eval(
                counters, eval_copy(ev["base"], "eval_rpc"), sl["demos"],
                ("--env", f"rpc://{address}", *EVAL_ARGS))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    envs, orig_make = [], eval_runner.make_env

    def kept_env(*args):
        envs.append(orig_make(*args))
        return envs[-1]

    eval_runner.make_env = kept_env
    try:
        with timed_methods((TranscriptReplayEnv, "step")) as rep:
            t_calls, t_launches, t_rows, transcript_s, _ = drive_eval(
                counters, eval_copy(ev["base"], "eval_transcript"),
                sl["demos"], ("--env", f"transcript://{session}", *EVAL_ARGS))
    finally:
        eval_runner.make_env = orig_make
    replay = envs[0]
    exhausted = (isinstance(replay, TranscriptReplayEnv)
                 and replay._i == len(replay.records))
    expect = lambda n: {k: 0 for k in counters} | {
        "flash_self_attention_fwd": m.transformer_depth * n}
    rpc_step = statistics.median(rpc.ms["RPCEnvClient.step"])
    mock_step = statistics.median(ev["mock_step_ms"])
    ok = (line.startswith("[sim-host] serving mock env on 127.0.0.1:")
          and rows == ev["rows"] and t_rows == ev["rows"] and exhausted
          and launches == expect(calls) and t_launches == expect(t_calls)
          and calls == t_calls)
    log("eval_rpc", server_line=line, rows_equal_mock=rows == ev["rows"],
        transcript_rows_equal_mock=t_rows == ev["rows"],
        transcript_exhausted=exhausted,
        transcript_records=len(replay.records), act_calls=calls,
        launches=launches, transcript_launches=t_launches,
        rpc_step_ms=rpc.ms["RPCEnvClient.step"],
        rpc_reset_ms=rpc.ms["RPCEnvClient.reset_to_demo"],
        rpc_step_ms_median=rpc_step, mock_step_ms_median=mock_step,
        rpc_added_ms_a_step=rpc_step - mock_step,
        transcript_step_ms_median=statistics.median(
            rep.ms["TranscriptReplayEnv.step"]),
        rpc_s=rpc_s, transcript_s=transcript_s,
        seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError("the RPC / transcript eval failed its checks")
    return {"launches": launches, "transcript_launches": t_launches}


# one AdamW step on the card against the plain formula on CPU fp64 copies,
# with optax's constants (the moments' decays as Python floats, the bias
# corrections 1 - b^t in float32): each value within 2^-20 of the sum of
# its terms' magnitudes, carried through the formula (|b·m| + |(1 - b)·g|
# for m, the same for v; |p| + lr·(that of m / c1 / (√v̂ + eps) + wd·|p|)
# for the parameters): the float32 step rounds a few times, and m is often
# a difference of two close terms, whose rounding the update inherits (my
# chip run 2, PR 11: 4.9 × a bound that used |update| alone, on the CPU's
# float32 step as on the card's)
ADAM_TOL = 2.0 ** -20


def adam_plain_check(opt) -> dict:
    """`opt.step()` on the card from its present state and gradients (w_geo
    clips none), held to the plain AdamW formula in fp64 on CPU copies."""
    import numpy as np
    import torch
    assert opt.grad_clip_norm == 0
    g = [(p.grad if p.grad is not None else torch.zeros_like(p))
         .double().cpu() for p in opt.params]
    p0 = [p.detach().double().cpu() for p in opt.params]
    m0 = [m.double().cpu() for m in opt.mu]
    v0 = [v.double().cpu() for v in opt.nu]
    lr, t, b1, b2 = opt.current_lr(), opt.count + 1, opt.b1, opt.b2
    c1, c2 = (float(1 - np.float32(b) ** np.float32(t)) for b in (b1, b2))
    m1 = [b1 * m + (1 - b1) * x for m, x in zip(m0, g)]
    v1 = [b2 * v + (1 - b2) * x * x for v, x in zip(v0, g)]
    upd = [(m / c1) / (torch.sqrt(v / c2) + opt.eps) + opt.weight_decay * p
           for p, m, v in zip(p0, m1, v1)]
    p1 = [p - lr * u for p, u in zip(p0, upd)]
    m_mag = [(b1 * m).abs() + ((1 - b1) * x).abs() for m, x in zip(m0, g)]
    scales = {"params": [p.abs() + lr * ((mm / c1) / (torch.sqrt(v / c2)
                                                       + opt.eps)
                                         + opt.weight_decay * p.abs())
                         for p, mm, v in zip(p0, m_mag, v1)],
              "mu": m_mag,
              "nu": [(b2 * v).abs() + (1 - b2) * x * x
                     for v, x in zip(v0, g)]}
    # the same step in float32 on the CPU, beside the card's
    host = type(opt)([x.float().clone() for x in p0], opt.lr, b1=b1, b2=b2,
                     eps=opt.eps, weight_decay=opt.weight_decay)
    host.load_state_dict(opt.state_dict())
    for q, x in zip(host.params, g):
        q.grad = x.float()
    host.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    errs, worst = {}, {}
    for name, card, cpu, plain in (
            ("params", opt.params, host.params, p1),
            ("mu", opt.mu, host.mu, m1), ("nu", opt.nu, host.nu, v1)):
        ratios = [((a.detach().double().cpu() - b).abs()
                   / (ADAM_TOL * sc + 1e-38)) for a, b, sc in
                  zip(card, plain, scales[name])]
        leaf = max(range(len(ratios)), key=lambda i: float(ratios[i].max()))
        at = int(ratios[leaf].argmax())
        errs[name] = float(ratios[leaf].reshape(-1)[at])
        errs[name + "_cpu_fp32"] = max(
            float(((a.double() - b).abs() / (ADAM_TOL * sc + 1e-38)).max())
            for a, b, sc in zip(cpu, plain, scales[name]))
        flat = lambda x: float(x.detach().double().cpu().reshape(-1)[at])
        worst[name] = {"leaf": leaf, "shape": list(p0[leaf].shape),
                       "p0": flat(p0[leaf]), "g": flat(g[leaf]),
                       "m0": flat(m0[leaf]), "v0": flat(v0[leaf]),
                       "update": flat(upd[leaf]), "card": flat(card[leaf]),
                       "cpu_fp32": flat(cpu[leaf]), "plain": flat(
                           (p1 if name == "params" else m1 if name == "mu"
                            else v1)[leaf])}
    card_equals_cpu = all(torch.equal(a.detach().cpu(), b) for a, b in
                          zip(opt.params + opt.mu + opt.nu,
                              host.params + host.mu + host.nu))
    return {"leaves": len(p0), "values": sum(p.numel() for p in p0),
            "lr": lr, "count": t, "step_ms": step_ms,
            "error_over_tol": errs, "worst": worst,
            "card_equals_cpu_fp32_bitwise": card_equals_cpu,
            "ok": max(errs[k] for k in ("params", "mu", "nu")) <= 1.0}


def phase_adam_slice(counters: dict, demos: str, lamb_step_ms: float) -> dict:
    """`method.optimizer=adam` through the train entry point at full `w_geo`
    width: 3 steps and a resume (`phase_train_slice`: finite losses, the
    launches of every step); the optimizer state the resume restored equal
    to the saved one bit for bit; then one more AdamW step on the card from
    the last step's gradients against the plain formula in fp64."""
    import torch
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    from manigaussian_tpu_torch.runners import offline_train_runner as runner
    from manigaussian_tpu_torch.utils.optimizers import AdamW

    agents, restored = [], []
    orig_update, orig_restore = ManiGaussianBCAgent.update, runner.restore_checkpoint

    def kept_update(self, *args, **kwargs):
        agents[:] = [self]
        return orig_update(self, *args, **kwargs)

    def kept_restore(logdir, module, step=None, optimizer=None):
        out = orig_restore(logdir, module, step=step, optimizer=optimizer)
        state = optimizer.state_dict()
        restored.append((out[1], {**state, **{k: [t.clone() for t in state[k]]
                                              for k in ("mu", "nu")}}))
        return out

    ManiGaussianBCAgent.update = kept_update
    runner.restore_checkpoint = kept_restore
    t0 = time.time()
    try:
        tr = phase_train_slice(counters, "w_geo", ("method.optimizer=adam",),
                               steps=3, demos=demos, label="adam_slice")
    finally:
        ManiGaussianBCAgent.update = orig_update
        runner.restore_checkpoint = orig_restore
    step, state = restored[-1]
    saved = torch.load(os.path.join(tr["logdir"], "seed0", "weights",
                                    str(step), "optimizer.pt"),
                       weights_only=True)
    same = (state["kind"] == saved["kind"] == "adam"
            and state["count"] == saved["count"] == step + 1
            and all(torch.equal(a, b) for a, b in
                    zip(state["mu"] + state["nu"], saved["mu"] + saved["nu"])))
    opt = agents[0].optimizer()
    check = adam_plain_check(opt)
    ok = same and type(opt) is AdamW and check["ok"]
    log("adam_slice_check", restored_step=step,
        restored_equals_saved=same, plain_check=check,
        tol=f"{ADAM_TOL} of the sum of the terms' magnitudes",
        adam_step_ms_median=tr["step_ms"], lamb_step_ms_median=lamb_step_ms,
        seconds=time.time() - t0, ok=ok)
    if not ok:
        raise AssertionError("the Adam slice failed its checks")
    return tr


def phase_disk_slice(counters: dict, demos: str) -> dict:
    """The train entry point with the default `replay.use_disk=true` at full
    `w_geo` width: 3 steps and a resume (`phase_train_slice`, the resume
    reopening the record log); the replay must use the native store (no
    fallback to pickles). Then a run with the pickle layout (the store's
    default storage switched for it) from the same demos and seed: its
    first 3 batches equal the native run's bit for bit. The wait in
    `next(batches)` and the replay's sampling time of both layouts."""
    import numpy as np
    from manigaussian_tpu_torch import train as train_cli
    from manigaussian_tpu_torch.data.pipeline import BatchIterator
    from manigaussian_tpu_torch.data import replay as replay_module
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay

    class PickleReplay(TaskUniformReplay):
        """The replay the train entry point builds, in the pickle layout."""

        def __init__(self, save_dir=None, shard=(0, 1)):
            super().__init__(save_dir, shard, storage="pickle")

    seen = {}                 # layout → each run's storage, batches, waits
    runs, orig_init, orig_next = [], BatchIterator.__init__, BatchIterator.__next__

    def kept_init(self, replay, *args, **kwargs):
        orig_init(self, replay, *args, **kwargs)
        runs.append({"storage": replay.storage, "batches": [], "wait_ms": []})
        self._smoke_run = runs[-1]

    def kept_next(self):
        t0 = time.perf_counter()
        batch = orig_next(self)
        self._smoke_run["wait_ms"].append((time.perf_counter() - t0) * 1e3)
        if len(self._smoke_run["batches"]) < 3:
            self._smoke_run["batches"].append(
                {k: np.array(v) for k, v in batch.items()})
        return batch

    native_dir = os.path.join(WORK, "replay_native")
    pickle_dir = os.path.join(WORK, "replay_pickle")
    for d in (native_dir, pickle_dir):
        shutil.rmtree(d, ignore_errors=True)
    BatchIterator.__init__, BatchIterator.__next__ = kept_init, kept_next
    t0 = time.time()
    try:
        tr = phase_train_slice(
            counters, "w_geo", ("replay.use_disk=true",
                                f"replay.path={native_dir}"),
            steps=3, demos=demos, label="disk_slice")
        seen["native"] = runs[:]
        runs.clear()
        replay_module.TaskUniformReplay = PickleReplay
        try:
            train_cli.main(["--demo-root", demos, "--logdir",
                            os.path.join(WORK, "train_logs_disk_pickle"),
                            *TRAIN_OVERRIDES, "replay.use_disk=true",
                            f"replay.path={pickle_dir}",
                            "framework.training_iterations=3"])
        finally:
            replay_module.TaskUniformReplay = TaskUniformReplay
        seen["pickle"] = runs[:]
    finally:
        BatchIterator.__init__, BatchIterator.__next__ = orig_init, orig_next
    task_dir = os.path.join(native_dir, TASK)
    native_files = sorted(os.listdir(task_dir))
    pickles = [f for f in os.listdir(os.path.join(pickle_dir, TASK))
               if f.endswith(".replay")]
    first, other = seen["native"][0], seen["pickle"][0]
    equal = (len(first["batches"]) == len(other["batches"]) == 3
             and all(a.keys() == b.keys()
                     and all(a[k].dtype == b[k].dtype
                             and np.array_equal(a[k], b[k]) for k in a)
                     for a, b in zip(first["batches"], other["batches"])))
    sample_ms = {}
    for layout, path in (("native", native_dir), ("pickle", pickle_dir)):
        replay = TaskUniformReplay(save_dir=path, storage=layout)
        replay.reload_from_disk()
        rng = np.random.default_rng(0)
        wall = []
        for _ in range(20):
            t1 = time.perf_counter()
            replay.sample(1, rng)
            wall.append((time.perf_counter() - t1) * 1e3)
        sample_ms[layout] = statistics.median(wall)
    ok = (all(r["storage"] == "native" for r in seen["native"])
          and len(seen["native"]) == 2
          and native_files == ["records.bin", "records.idx"]
          and [r["storage"] for r in seen["pickle"]] == ["pickle"]
          and len(pickles) > 0 and equal)
    log("disk_slice_check", storage=[r["storage"] for r in seen["native"]],
        record_files=native_files,
        record_bytes=os.path.getsize(os.path.join(task_dir, "records.bin")),
        pickle_files=len(pickles), first_batches_equal_pickle_layout=equal,
        next_batch_wait_ms={"native": first["wait_ms"],
                            "native_resume": seen["native"][1]["wait_ms"],
                            "pickle": other["wait_ms"]},
        next_batch_wait_ms_median_after_1={
            k: statistics.median(r["wait_ms"][1:]) for k, r in
            (("native", first), ("pickle", other))},
        sample_one_ms_median=sample_ms, seconds=time.time() - t0, ok=ok)
    if not ok:
        raise AssertionError("the native replay store slice failed its checks")
    return tr


def random_scene(n: int = 16384, seed: int = 0) -> dict:
    """`random_frame`'s Gaussians (numpy draws), as float32 arrays."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f = np.float32
    means = np.array([0.0, 0.0, 2.0]) + 0.5 * rng.standard_normal((n, 3))
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 3)))
    q = rng.standard_normal((n, 4))
    return {"means3d": means.astype(f), "scales": scales.astype(f),
            "rotations": (q / np.linalg.norm(q, axis=-1,
                                             keepdims=True)).astype(f),
            "opacities": rng.uniform(0.05, 0.95, n).astype(f),
            "shs": (0.3 * rng.standard_normal((n, 4, 3))).astype(f),
            "language_features": rng.standard_normal((n, 3)).astype(f)}


def phase_two_level(counters: dict) -> dict:
    """The rasterizer's two-level duplication on the training frame (16,384
    Gaussians, 128², the blend kernels): with `small_rect_cap` 4 and a table
    of every big Gaussian, the image, features, transmittance and the
    Gaussians' gradients equal the single-level render's bit for bit (the
    same splats in the same key order; the Gaussians past r_cap tiles are
    cut alike); with a table of a quarter of them, `overflow_gaussians`
    (more than the single level's) and the image equal the plain route's
    on the CPU (the image under the golden rule). The sort lengths and the
    bin/sort time of both."""
    import torch
    from manigaussian_tpu_torch.ops import gaussian_math as gm
    from manigaussian_tpu_torch.ops.camera import novel_camera_calib
    from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                       rasterize, tile_lists)

    scene, hw = random_scene(), 128
    keys = ("means3d", "opacities", "scales", "rotations", "shs",
            "language_features")

    def camera(dev):
        intr = torch.tensor([[hw * 0.95, 0, hw / 2], [0, hw * 0.95, hw / 2],
                             [0, 0, 1]], device=dev)
        cam = novel_camera_calib(intr[None], torch.eye(4, device=dev)[None],
                                 0.1, 4.0, hw, hw)
        return type(cam)(*(f[0] for f in cam))

    def render(cfg, dev="cuda", grads=True):
        p = {k: torch.tensor(scene[k], device=dev).requires_grad_(grads)
             for k in keys}
        out, ex = rasterize(p["means3d"], p["opacities"], camera(dev), cfg,
                            (0.0, 0.0, 0.0), p["scales"], p["rotations"],
                            p["shs"], p["language_features"])
        if grads:
            ((out.color ** 2).sum() + out.language_feature.sum()
             + out.final_t.sum()).backward()
        return out, ex, [p[k].grad for k in keys] if grads else []

    t_phase = time.time()
    single = RasterizeConfig(width=hw, height=hw)
    cam = camera("cuda")
    t = lambda k: torch.tensor(scene[k], device="cuda")[None]
    pre = gm.preprocess(t("means3d"), t("opacities"),
                        type(cam)(*(f[None] for f in cam)), hw, hw, 16,
                        scales=t("scales"), rotations=t("rotations"),
                        shs=t("shs"))
    s_cap, r_cap, n = 4, single.max_tiles_per_gaussian, len(scene["means3d"])
    n_big = int((pre.tiles_touched > s_cap).sum())
    full = single._replace(small_rect_cap=s_cap, big_table_cap=n_big)
    small = single._replace(small_rect_cap=s_cap, big_table_cap=n_big // 4)
    s_out, s_ex, s_grads = render(single)
    for fn in counters.values():
        fn.launches = 0
    t_out, t_ex, t_grads = render(full)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    bitwise = (all(torch.equal(a, b) for a, b in zip(s_out, t_out))
               and all(torch.equal(a, b) for a, b in zip(s_grads, t_grads)))
    k_out, k_ex, _ = render(small, grads=False)
    c_out, c_ex, _ = render(small, dev="cpu", grads=False)
    img = mostly_close(k_out.color.detach().cpu(), c_out.color.detach(),
                       1e-4, 1e-3)
    overflow = (int(k_ex.overflow_gaussians), int(c_ex.overflow_gaussians))
    times = {name: cuda_ms(lambda c=c: tile_lists(pre, c), iters=20)
             for name, c in (("single", single), ("two_level", full))}
    lengths = {"single": n * r_cap, "two_level": n * s_cap + n_big * r_cap,
               "two_level_quarter_table": n * s_cap + (n_big // 4) * r_cap}
    ok = (bitwise and int(t_ex.overflow_gaussians)
          == int(s_ex.overflow_gaussians)
          and overflow[0] == overflow[1] > int(s_ex.overflow_gaussians)
          and img[0]
          and launches == {k: 0 for k in counters} | {"blend_fwd": 1,
                                                       "blend_bwd": 1})
    log("two_level", gaussians=n, big_gaussians=n_big, small_rect_cap=s_cap,
        r_cap=r_cap, tables=[n_big, n_big // 4],
        equal_single_level_bitwise=bitwise, launches=launches,
        overflow_gaussians_single_level=int(s_ex.overflow_gaussians),
        overflow_gaussians_small_table_card_cpu=overflow,
        overflow_splats=[int(s_ex.overflow_splats),
                         int(t_ex.overflow_splats)],
        small_table_image_frac_outside_max_diff=img[1:],
        sort_lengths=lengths, bin_sort_ms=times,
        rule="image atol 1e-4 rtol 1e-3, ≤0.5 % outside",
        seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError("the two-level duplication failed its checks")
    return {"launches": launches}


def phase_dino_swiglu() -> dict:
    """The DINOv2 directory route with the SwiGLU MLP of the giant model: a
    tiny SwiGLU DINOv2 (patch 14, width 64, 2 layers, a 5² position grid)
    with seeded random weights, written by the port's `save_hf_dir`
    (`use_swiglu_ffn` true), loaded through `create_feature_extractor(
    "dinov2", <dir>)` on the card and on the CPU; the features of two 128²
    views agree within DINO_TOL of their scale (fp32, TF32 off)."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.models.dinov2 import DinoV2ViT, save_hf_dir
    from manigaussian_tpu_torch.models.foundation import \
        create_feature_extractor
    t_phase = time.time()
    gen = torch.Generator().manual_seed(1)
    model = DinoV2ViT(patch_size=14, width=64, layers=2, heads=2, pos_grid=5,
                      swiglu=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
    path = os.path.join(WORK, "dinov2_swiglu_dir")
    save_hf_dir(path, model, size={"shortest_edge": 112},
                crop_size={"height": 98, "width": 98})
    rgb = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, 128, 128, 3)).astype(np.float32))
    card = create_feature_extractor("dinov2", path, device="cuda")
    cpu = create_feature_extractor("dinov2", path, device="cpu")
    fc = card(rgb.cuda()).cpu()
    fp = cpu(rgb)
    scale = float(fp.abs().max())
    err = float((fc - fp).abs().max())
    ok = (card.model.swiglu and cpu.model.swiglu
          and tuple(fc.shape) == (2, 128, 128, 64)
          and bool(torch.isfinite(fc).all())
          and err <= DINO_TOL * max(1.0, scale))
    log("dino_swiglu", hidden=card.model.blocks[0].mlp.w3.in_features,
        shape=list(fc.shape), max_abs_err_card_vs_cpu=err, scale=scale,
        tol=DINO_TOL, seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError(f"dino_swiglu: card against CPU {err} (scale "
                             f"{scale}), shape {tuple(fc.shape)}")
    return {"max_abs_err": err}


def stand_in_bpe(path: str) -> str:
    """A BPE merge list of CLIP's size (48,894 merges after a header line; a
    few real-looking ones, then unique ones that never apply; its ids are
    not CLIP's): the card machine has no vocab, and the CLIP provider needs
    a tokenizer."""
    import gzip
    merges = ["o p", "op e", "ope n</w>", "t h", "th e</w>", "d r", "dr a",
              "dra w", "draw e", "drawe r</w>"]
    merges += [f"q{i} z{i}" for i in range(49152 - 256 - 2 - len(merges))]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return path


def phase_towers_msgpack() -> dict:
    """The three frozen towers through the port's `.msgpack` route, at tiny
    seeded widths: a torch checkpoint of each (CLIP text: width 64, 2
    layers, context 16, vocab 49408; DINOv2: patch 14, width 64, 2 layers;
    SD VAE: ch 32, 4 levels), converted by the port's writer
    (`tools/convert_weights`, flax's format in pure Python), loaded through
    each tower's user-facing class on the card from the `.msgpack` and from
    the checkpoint: their outputs equal bit for bit, and the file read back
    and written again gives the same bytes."""
    import torch
    from manigaussian_tpu_torch.data.language import ClipRN50TextModel
    from manigaussian_tpu_torch.models import clip_text as ct
    from manigaussian_tpu_torch.models import sd_vae as sv
    from manigaussian_tpu_torch.models.dinov2 import (DinoV2Extractor,
                                                      DinoV2ViT)
    from manigaussian_tpu_torch.models.foundation import \
        SDVaeFeatureExtractor
    from manigaussian_tpu_torch.tools import convert_weights as cw
    t_phase = time.time()
    d = os.path.join(WORK, "towers")
    os.makedirs(d, exist_ok=True)
    gen = torch.Generator().manual_seed(3)
    clip = ct.ClipTextTransformer(context_length=16, width=64, heads=8,
                                  layers=2, embed_dim=32).init_params(gen)
    dino = DinoV2ViT(patch_size=14, width=64, layers=2, heads=1, pos_grid=5)
    with torch.no_grad():
        for p in dino.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    vae = sv.SDVae(ch=32).init_params(gen)
    ckpts = {"clip": {k: v for k, v in clip.state_dict().items()},
             "dinov2": dino.state_dict(), "sd_vae": {
                 "state_dict": {f"first_stage_model.{k}": v
                                for k, v in vae.state_dict().items()}}}
    bpe = stand_in_bpe(os.path.join(d, "bpe.txt.gz"))
    rgb = torch.linspace(0, 1, 2 * 64 * 64 * 3).reshape(2, 64, 64, 3).cuda()
    ids = torch.zeros(2, 16, dtype=torch.long, device="cuda")
    ids[0, :5] = torch.tensor([49406, 320, 1125, 539, 49407])
    ids[1, :9] = torch.tensor([49406, 7, 70, 700, 7000, 17000, 27000, 37000,
                               49407])

    def outputs(name, path):
        if name == "clip":
            m = ClipRN50TextModel(path, bpe_path=bpe, device="cuda")
            with torch.no_grad():
                sent, toks = m.model(ids)
            return [sent, toks, torch.from_numpy(
                m.encode("open the drawer")[0])]
        if name == "dinov2":
            return [DinoV2Extractor(path, device="cuda")(rgb)]
        return [SDVaeFeatureExtractor(path, feature_hw=64,
                                      device="cuda")(rgb)]

    res = {}
    for name, sd in ckpts.items():
        pt = os.path.join(d, f"{name}.pt")
        mp = os.path.join(d, f"{name}.msgpack")
        torch.save(sd, pt)
        getattr(cw, f"convert_{name}")(pt, mp)
        with open(mp, "rb") as f:
            data = f.read()
        direct, converted = outputs(name, pt), outputs(name, mp)
        res[name] = {
            "bytes": len(data),
            "rewrite_equal": cw.msgpack_serialize(cw.msgpack_restore(data))
            == data,
            "dims": cw.load_converted(mp)["dims"],
            "shapes": [list(t.shape) for t in converted],
            "bitwise": all(torch.equal(a, b) for a, b in zip(direct,
                                                            converted)),
            "finite": all(bool(torch.isfinite(t).all()) for t in converted)}
    ok = all(r["bitwise"] and r["rewrite_equal"] and r["finite"]
             for r in res.values())
    log("towers_msgpack", towers=res, seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError(f"towers_msgpack: {res}")
    return res


# the near and far planes of the exported depth PNGs (24-bit fixed point
# over 4.49 m: steps of 2.7e-7 m; the synthetic scene's depths lie within)
EXPORT_NEAR, EXPORT_FAR = 0.01, 4.5


def export_reference_demos(src: str, dst: str, task: str) -> float:
    """Write the port's native demos under `src` in the reference's on-disk
    layout under `dst` (as tests/test_import_rlbench.py builds it): a
    pickled rlbench `Demo` of `Observation`s (classes from fabricated module
    shims), the RGB PNGs, the depth as 24-bit RGB-packed PNGs between
    EXPORT_NEAR and EXPORT_FAR, variation_descriptions.pkl and nerf_data
    copied. Returns the largest depth error of the PNG round trip."""
    import pickle
    import types
    import numpy as np
    from manigaussian_tpu_torch.data import episode as ep
    from manigaussian_tpu_torch.tools.import_rlbench import (decode_depth_png,
                                                             encode_depth_png)
    mods = {n: sys.modules.get(n) or types.ModuleType(n)
            for n in ("rlbench", "rlbench.demo", "rlbench.backend",
                      "rlbench.backend.observation")}

    class Demo:
        def __init__(self, observations):
            self._observations = observations

    class Observation:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    Demo.__module__, Demo.__qualname__ = "rlbench.demo", "Demo"
    Observation.__module__ = "rlbench.backend.observation"
    Observation.__qualname__ = "Observation"
    mods["rlbench.demo"].Demo = Demo
    mods["rlbench.backend.observation"].Observation = Observation
    sys.modules.update(mods)
    worst = 0.0
    for path in ep.list_episodes(src, task):
        demo = ep.load_episode(path)
        out = os.path.join(dst, task, ep.VARIATIONS_ALL_FOLDER,
                           ep.EPISODES_FOLDER, os.path.basename(path))
        for sub in ("front_rgb", "front_depth"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)
        obs = []
        for t in range(len(demo)):
            shutil.copy(os.path.join(path, "front_rgb", f"{t}.png"),
                        os.path.join(out, "front_rgb", f"{t}.png"))
            depth = ep.load_depth(demo.depth_paths["front"][t])
            png = os.path.join(out, "front_depth", f"{t}.png")
            encode_depth_png((depth - EXPORT_NEAR)
                             / (EXPORT_FAR - EXPORT_NEAR)).save(png)
            worst = max(worst, float(np.abs(decode_depth_png(
                png, EXPORT_NEAR, EXPORT_FAR) - depth).max()))
            obs.append(Observation(
                gripper_open=float(demo.gripper_open[t]),
                gripper_pose=np.asarray(demo.gripper_pose[t], np.float64),
                gripper_joint_positions=np.asarray(
                    demo.gripper_joint_positions[t], np.float64),
                joint_velocities=np.asarray(demo.joint_velocities[t],
                                            np.float64),
                ignore_collisions=np.float64(demo.ignore_collisions[t]),
                misc={"front_camera_extrinsics":
                      demo.camera_extrinsics["front"][t],
                      "front_camera_intrinsics":
                      demo.camera_intrinsics["front"][t],
                      "front_camera_near": EXPORT_NEAR,
                      "front_camera_far": EXPORT_FAR}))
        with open(os.path.join(out, "low_dim_obs.pkl"), "wb") as f:
            pickle.dump(Demo(obs), f)
        with open(os.path.join(out, "variation_descriptions.pkl"), "wb") as f:
            pickle.dump(list(demo.descriptions), f)
        shutil.copytree(os.path.join(path, ep.NERF_FOLDER),
                        os.path.join(out, ep.NERF_FOLDER))
    return worst


IMPORT_STEPS = 3
# the first step's losses on the imported demos against train_slice's on
# the same seed, relative to max(1, |x|): the depths moved by the 24-bit
# PNGs (≤ 2.7e-7 m) and the cameras by float32, so the point clouds differ
# in the last bits and the kernels' bf16 matmuls may round a few of them
# apart
IMPORT_TOL = 2e-2


def phase_imported_train(counters: dict, tr: dict) -> dict:
    """The RLBench demo importer on the training path: train_slice's demos
    exported in the reference's layout (`export_reference_demos`), imported
    by `python -m manigaussian_tpu_torch.tools.import_rlbench` (a
    subprocess, the user's command), then `w_geo` at full width for
    IMPORT_STEPS steps and a resume through the train entry point on the
    imported demos (`phase_train_slice`: the launches of every step, the
    recon render's at step 0). The first step's losses beside train_slice's
    on the same seed (within IMPORT_TOL), the depth round trip's error."""
    t_phase = time.time()
    ref = os.path.join(WORK, "rlbench_reference")
    native = os.path.join(WORK, "rlbench_imported")
    depth_err = export_reference_demos(tr["demos"], ref, TASK)
    rc, out, err = run_cli(
        ["-m", "manigaussian_tpu_torch.tools.import_rlbench", "--src", ref,
         "--dst", native, "--tasks", TASK], 300)
    if rc or json.loads(out.strip().splitlines()[-1]) != {TASK: 2}:
        raise AssertionError(f"import_rlbench: exit {rc}\n{out}\n{err}")
    it = phase_train_slice(counters, "w_geo", (), steps=IMPORT_STEPS,
                           demos=native, label="imported_train")
    ours, theirs = it["losses_first"], tr["losses_first"]
    heads = ("total_loss", "trans_loss", "rot_loss", "grip_loss",
             "collision_loss", "rgb_loss", "psnr")
    diffs = {k: abs(ours[k] - theirs[k]) / max(1.0, abs(theirs[k]))
             for k in heads}
    ok = (max(diffs.values()) <= IMPORT_TOL and depth_err <= 1e-6
          and all(it["launches"][k] for k in ("flash_self_attention_fwd",
                                              "flash_self_attention_bwd",
                                              "blend_fwd", "blend_bwd")))
    log("imported_train", depth_png_max_err_m=depth_err,
        first_step_imported=ours, first_step_train_slice=theirs,
        rel_diff=diffs, tol=IMPORT_TOL, launches=it["launches"],
        step_ms_median=it["step_ms"], seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError(f"imported_train: {diffs}, depth {depth_err}")
    return it


SCALING_ITERS = 8
SCALING_N, SCALING_SIZE = 65536, 128
# the DP step's gradient buffer at w_geo width (PERF.md §5)
W_GEO_PARAMS = 39_811_941


def _launch_snapshot(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def phase_scaling(counters: dict) -> dict:
    """The scaling twin (`python -m manigaussian_tpu_torch.bench_scaling`)
    on the card. Two runs of two `--dist` ranks that share the card over
    gloo (`--dist-backend gloo`): rank 0 in this process (its launches
    counted), rank 1 a subprocess. The timed run (`--weak --train-step`,
    65,536 Gaussians at 128², SCALING_ITERS iterations): strong and weak
    render rows and the tiny config's DP rows at D = 1 (rank 0 alone) and
    D = 2 (`platform_limited`: two ranks on one card, no scaling figure);
    the `--comm-model --train-step` run: the render's and the `w_geo` DP
    step's collective bytes, each t_comp the D = 1 time of this run. The
    render's bytes equal the reckoning from its shapes; the DP step's
    all-reduce equals the port's reckoning from its parameters and metrics
    and holds at least the 39,811,941 float32 gradients. Launches by path:
    each D = 1 render and each D = 2 render on rank 0 one blend forward and
    one backward; the D = 1 tiny DP step `expected_launches`."""
    import torch
    from manigaussian_tpu_torch import bench_scaling as bs
    from manigaussian_tpu_torch.parallel.distributed import (dist_spec,
                                                             free_port)
    t_phase = time.time()
    out = os.path.join(WORK, "scaling.jsonl")
    paths = {}
    orig_render, orig_dp = bs.render_step, bs._dp_step

    def counted(label, fn):
        def call():
            before = _launch_snapshot(counters)
            res = fn()
            acc = paths.setdefault(label, dict.fromkeys(counters, 0))
            for k, v in _launch_snapshot(counters).items():
                acc[k] += v - before[k]
            return res
        return call

    def counted_render(run, scene, size, cfg, mesh=None):
        d = 1 if mesh is None else mesh.size("tile")
        return counted(f"scaling_render_d{d}" + ("_rank0" if d > 1 else ""),
                       orig_render(run, scene, size, cfg, mesh))

    def counted_dp(run, cfg, d, img):
        # the timed rows' tiny config (32²) or the comm model's w_geo
        agent, fn = orig_dp(run, cfg, d, img)
        kind = "train" if img == 32 else "comm_train_w_geo"
        return agent, counted(f"scaling_{kind}_d{d}"
                              + ("_rank0" if d > 1 else ""), fn)

    common = ["--n", str(SCALING_N), "--size", str(SCALING_SIZE), "--iters",
              str(SCALING_ITERS), "--dist-backend", "gloo", "--out", out]
    runs = {"timed": ["--weak", "--train-step"],
            "comm_model": ["--comm-model", "--train-step"]}
    bs.render_step, bs._dp_step = counted_render, counted_dp
    try:
        for flags in runs.values():
            port = free_port()
            proc = subprocess.Popen(
                [sys.executable, "-m", "manigaussian_tpu_torch.bench_scaling",
                 "--dist", dist_spec(port, 2, 1), *common, *flags],
                cwd=ROOT, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, start_new_session=True)
            try:
                bs.main(["--dist", dist_spec(port, 2, 0), *common, *flags])
                _, err = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, 9)
                    proc.communicate()
            if proc.returncode:
                raise AssertionError(f"scaling rank 1: exit {proc.returncode}"
                                     f"\n{err[-3000:]}")
    finally:
        bs.render_step, bs._dp_step = orig_render, orig_dp
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    by = {(r["metric"], r["devices"]): r for r in rows}
    n, s = SCALING_N, SCALING_SIZE
    render_comm = by[("render_comm_model", 2)]
    dp_comm = by[("dp_train_step_comm_model", 2)]
    reckoned = {"all-reduce": 4 * 3 * n + 8, "all-gather": 4 * 7 * s * s,
                "reduce-scatter": 0, "collective-permute": 0}
    tiny = bs.tiny_config().method
    renders = 2 * (SCALING_ITERS + 1)       # strong and weak, warm-up each
    expect = {"scaling_render_d1": {"blend_fwd": renders,
                                    "blend_bwd": renders},
              "scaling_render_d2_rank0": {"blend_fwd": renders + 1,
                                          "blend_bwd": renders + 1},
              "scaling_train_d1": {}}
    for step in range(SCALING_ITERS + 1):
        for k, v in expected_launches(tiny, step).items():
            expect["scaling_train_d1"][k] = \
                expect["scaling_train_d1"].get(k, 0) + v
    full = {p: {k: e.get(k, 0) for k in counters} for p, e in expect.items()}
    got = {p: paths.get(p) for p in full}
    wg = train_config("w_geo").method
    w_geo_steps = {k: sum(expected_launches(wg, i)[k]
                          for i in range(SCALING_ITERS + 1))
                   for k in counters}
    extra_ok = (paths.get("scaling_comm_train_w_geo_d1") == w_geo_steps
                and paths.get("scaling_comm_train_w_geo_d2_rank0")
                == expected_launches(wg, 0))
    # the comm-model run renders once more at D = 1 (its t_comp, with its
    # warm-up) and times the w_geo step at D = 1
    comm_d1 = SCALING_ITERS + 1
    full["scaling_render_d1"] = {
        k: v + (comm_d1 if k.startswith("blend") else 0)
        for k, v in full["scaling_render_d1"].items()}
    ok = (all(by.get((m, d)) for m in ("rays_per_s_fwd_bwd",
                                        "rays_per_s_per_device_weak",
                                        "dp_train_steps_per_s")
              for d in (1, 2))
          and all(by[(m, 2)]["platform_limited"]
                  and not by[(m, 1)]["platform_limited"]
                  for m in ("rays_per_s_fwd_bwd", "dp_train_steps_per_s"))
          and render_comm["collective_bytes"] == reckoned
          and dp_comm["collective_bytes"]["all-reduce"]
          == dp_comm["reckoned_all_reduce_bytes"]
          and dp_comm["param_bytes"] >= 4 * W_GEO_PARAMS
          and got == full and extra_ok)
    log("scaling", rows=rows, launches_by_path=paths, expected=full,
        expected_w_geo_d1=w_geo_steps,
        render_bytes_reckoned=reckoned, seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError(f"scaling: launches {got} against {full}, "
                             f"rows {rows}")
    return {"launches": paths, "rows": rows}


EXTRAS_KNN_N = 16384
KNN_REL = 1e-5
# |a|² + |b|² − 2a·b in float32 cancels for near neighbours: each side's
# rounding is within ≈ 20 units of 2^-24 of max|p|², whatever the order of
# summation, so the card and the CPU may differ by 2^-18 · max|p|² (the k
# smallest values move no more than the entries)
KNN_CANCEL = 2.0 ** -18
ATT3D_TOL = 1e-5
SSIM_REL = 1e-5


def phase_extras() -> dict:
    """The library modules no training path uses, the card against the CPU:
    `knn_mean_sq_dist` on the training frame's 16,384 points (true fp32):
    on the points rounded to a 2^-6 grid, where the arithmetic is exact,
    within KNN_REL relative, and as drawn within the cancellation bound
    KNN_CANCEL · max|p|²; `Visual3DLangTransformer` at width 64 on a 10³
    volume with 77 language tokens (output within ATT3D_TOL of its scale),
    `ssim` on two 128² views (within SSIM_REL relative); and
    `capture_trace` around one micro-config training step on the card: a
    Chrome trace with its kernels."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.config import micro_w_geo
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.models.attention3d import \
        Visual3DLangTransformer
    from manigaussian_tpu_torch.ops.knn import knn_mean_sq_dist
    from manigaussian_tpu_torch.ops.losses import ssim
    from manigaussian_tpu_torch.utils.profiling import capture_trace
    t_phase = time.time()
    raw = torch.from_numpy(random_scene(EXTRAS_KNN_N)["means3d"])
    grid = torch.round(raw * 64) / 64     # exact in float32 in any order
    knn = {}
    for name, pts in (("grid", grid), ("raw", raw)):
        card, cpu = knn_mean_sq_dist(pts.cuda()).cpu(), knn_mean_sq_dist(pts)
        knn[name] = {"max_rel_err": float(((card - cpu).abs()
                                           / cpu.abs()).max()),
                     "max_abs_err": float((card - cpu).abs().max()),
                     "bound": KNN_CANCEL * float((pts * pts).sum(-1).max())}
    knn_ms = cuda_ms(lambda: knn_mean_sq_dist(raw.cuda()), iters=5,
                     warmup=1)
    knn_ok = (knn["grid"]["max_rel_err"] <= KNN_REL
              and knn["raw"]["max_abs_err"] <= knn["raw"]["bound"])

    gen = torch.Generator().manual_seed(4)
    att = Visual3DLangTransformer(64, 512, heads=4, dim_head=32)
    with torch.no_grad():
        for p in att.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(1, 10, 10, 10, 64, generator=gen)
    lang = torch.randn(1, 77, 512, generator=gen)
    a_cpu = att(x, lang).detach()
    a_card = att.cuda()(x.cuda(), lang.cuda()).detach().cpu()
    att_err = float((a_card - a_cpu).abs().max())
    att_scale = max(1.0, float(a_cpu.abs().max()))

    rng = np.random.default_rng(5)
    i1, i2 = (torch.from_numpy(rng.uniform(size=(2, 128, 128, 3)).astype(
        np.float32)) for _ in range(2))
    s_cpu, s_card = float(ssim(i1, i2)), float(ssim(i1.cuda(), i2.cuda()))
    ssim_err = abs(s_card - s_cpu) / abs(s_cpu)

    agent = create_agent(micro_w_geo(), device="cuda")
    batch = micro_train_batch(b=1)
    agent.update(batch, torch.Generator().manual_seed(0))    # warm-up
    trace_dir = os.path.join(WORK, "trace")
    with capture_trace(trace_dir):
        float(agent.update(batch, torch.Generator().manual_seed(1))
              ["total_loss"])
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    ok = (knn_ok and att_err <= ATT3D_TOL * att_scale
          and ssim_err <= SSIM_REL and len(files) == 1 and kernels > 0)
    log("extras", knn_points=EXTRAS_KNN_N, knn=knn,
        knn_tol={"grid": f"{KNN_REL} relative",
                 "raw": "2^-18 · max|p|² absolute"},
        knn_card_ms=knn_ms, attention3d_max_abs_err=att_err,
        attention3d_scale=att_scale, attention3d_tol=ATT3D_TOL,
        ssim=[s_card, s_cpu], ssim_rel_err=ssim_err, ssim_tol=SSIM_REL,
        trace_file=files, trace_kernel_events=kernels,
        seconds=time.time() - t_phase, ok=ok)
    if not ok:
        raise AssertionError(f"extras: knn {knn}, attention3d {att_err}, "
                             f"ssim {ssim_err}, trace {files} {kernels}")
    return {}


# The user scripts' phases (manigaussian_tpu_torch/scripts/): the campaign
# cut in depth only, and the JAX summary's keys it must write
CAMPAIGN_ITERS = 60
CAMPAIGN_DEMOS = 2
CAMPAIGN_OVERRIDES = ("framework.log_freq=10", "framework.save_freq=30",
                      "method.neural_renderer.render_freq=30")
JAX_CAMPAIGN_SUMMARY = os.path.join(ROOT, "results", "flagship_campaign",
                                    "w_geo", "summary.json")


def run_counted(counters: dict, fn, *args, **kwargs):
    """fn(*args, **kwargs) with the counts set to 0 just before and read just
    after, and the agent's act calls counted: (result, launches, act calls,
    seconds)."""
    import torch
    from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
    calls, orig = [0], ManiGaussianBCAgent.act

    def counted(self, observation):
        calls[0] += 1
        return orig(self, observation)

    ManiGaussianBCAgent.act = counted
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.time()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        ManiGaussianBCAgent.act = orig
    return out, launches, calls[0], seconds


def training_launches(m, iters: int, act_calls: int = 0) -> dict:
    """A training run's launches from step 0: every step's, the recon
    render's at every `render_freq`-th step, and `act_calls` acts (the
    flash forward `transformer_depth` times each, with the conv kernels 2
    conv forwards)."""
    render_freq = m.neural_renderer.render_freq
    renders = len(range(0, iters, render_freq)) if render_freq else 0
    out = {k: sum(expected_launches(m, i)[k] for i in range(iters))
           + renders * v for k, v in expected_vis_launches(m).items()}
    out["flash_self_attention_fwd"] += act_calls * m.transformer_depth
    if m.policy_conv_impl == "pallas":
        out["conv3d_fwd"] += 2 * act_calls
    return out


def phase_campaign(counters: dict) -> dict:
    """`python -m manigaussian_tpu_torch.scripts.flagship_campaign --variant
    w_geo` through its main(), at `config.w_geo()`'s full width and the
    campaign's data shapes (128² camera, 21 nerf views, 20 steps an
    episode, 3 tasks), cut in depth only: CAMPAIGN_DEMOS demos a task,
    CAMPAIGN_ITERS iterations, log / save / render every 10 / 30 / 30
    steps. The counts are set to 0 just before and read just after (the
    steps and the recon renders: the flash pair and the blend pair). Checks:
    no non-finite cell, the JAX artifact's summary keys (feed's too), the
    last checkpoint restored into a new agent with finite parameters and
    LAMB's state, the feed's ms a batch below the step's median, the first
    and last recon panels written."""
    import torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.scripts import flagship_campaign as fc
    from manigaussian_tpu_torch.utils.checkpoint import restore_checkpoint

    work, out = os.path.join(WORK, "campaign"), os.path.join(WORK,
                                                             "campaign_out")
    argv = ["--variant", "w_geo", "--iters", str(CAMPAIGN_ITERS), "--demos",
            str(CAMPAIGN_DEMOS), "--work", work, "--out", out,
            *CAMPAIGN_OVERRIDES]
    summary, launches, acts, seconds = run_counted(counters, fc.main, argv)
    cfg = fc.build_cfg("w_geo", CAMPAIGN_ITERS, work=work,
                       overrides=CAMPAIGN_OVERRIDES, demos=CAMPAIGN_DEMOS)
    m = cfg.method
    expect = training_launches(m, CAMPAIGN_ITERS)
    with open(JAX_CAMPAIGN_SUMMARY) as f:
        jax_summary = json.load(f)
    logdir = os.path.join(work, "logs", "w_geo", "seed0")
    agent = create_agent(cfg, device="cuda")
    _, step = restore_checkpoint(logdir, agent.qfn,
                                 optimizer=agent.optimizer())
    params_finite = all(bool(torch.isfinite(p).all())
                        for p in agent.qfn.parameters())
    del agent
    step_ms = 1e3 / summary["steps_per_s_median"]
    art = os.path.join(out, "w_geo")
    panels = sorted(f for f in os.listdir(art) if f.endswith(".png"))
    ok = (summary["nonfinite_cells"] == 0
          and sorted(summary) == sorted(jax_summary)
          and sorted(summary["feed"]) == sorted(jax_summary["feed"])
          # the JAX summary's `iterations`: the last logged step + 1
          and summary["iterations"] == (CAMPAIGN_ITERS - 1) // 10 * 10 + 1
          and summary["logged_rows"] == len(range(0, CAMPAIGN_ITERS, 10))
          and step == CAMPAIGN_ITERS - 1 and params_finite
          and summary["feed"]["ms_per_batch"] < step_ms
          and panels == ["0.png", "30.png"]
          and launches == expect and acts == 0
          and sorted(os.listdir(art)) == sorted(
              ["config.json", "summary.json", "train.csv", *panels]))
    log("campaign", config="w_geo", voxel=m.voxel_sizes[0],
        latents=[m.num_latents, m.latent_dim], depth=m.transformer_depth,
        dtype=m.policy_dtype, image=[fc.H, fc.W], nerf_views=fc.NERF_VIEWS,
        timesteps=fc.TIMESTEPS, tasks=fc.TASKS,
        reduced={"demos_per_task": [CAMPAIGN_DEMOS, fc.DEMOS],
                 "iterations": [CAMPAIGN_ITERS, 10010],
                 "log_freq": [10, 50], "save_freq": [30, 2500],
                 "render_freq": [30, 1000]},
        summary=summary, step_ms_median=step_ms,
        feed_below_step=summary["feed"]["ms_per_batch"] < step_ms,
        launches=launches, expected=expect, restored_step=step,
        params_finite=params_finite, panels=panels, seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError("the flagship campaign failed its checks")
    return {"launches": launches, "summary": summary}


def phase_artifact(counters: dict) -> dict:
    """`make_results_artifact.run` as the JAX package's own miniature runs
    it (tests/test_results_artifact.py: 1 seed, 2 tasks, 40 iterations,
    `save_freq` 20, 1 held-out episode, 2 workers), on the card: the
    micro config's training in this process (the counts set to 0 just
    before and read just after: the fp32 flash pair, 8-wide heads, and the
    blend pair), the two checkpoints' evals in two spawned workers on the
    card, each counting its acts and launches (the flash forward an act).
    The per-seed CSV passes the reference format check
    (tests/test_results_artifact.py `_assert_reference_format`, in numpy);
    the summary is finite and best ≥ last."""
    import csv as csv_mod
    import multiprocessing
    import numpy as np
    import torch
    from manigaussian_tpu_torch.analysis.compute_results import (
        calculate_average_return, category_table, read_csv)
    from manigaussian_tpu_torch.config import micro_variant
    from manigaussian_tpu_torch.scripts import make_results_artifact as ra

    tasks = ("open_drawer", "turn_tap")
    out = os.path.join(WORK, "artifact")
    shutil.rmtree(os.path.join(WORK, "eval_workers"), ignore_errors=True)
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool
    ctx.Pool = lambda n: _CountedPool(pool(n))
    try:
        summary, launches, acts, seconds = run_counted(
            counters, ra.run, out, seeds=1, tasks=tasks, iterations=40,
            save_freq=20, episodes=1, workers=2,
            work_dir=os.path.join(WORK, "artifact_work"), device="cuda")
    finally:
        del ctx.Pool
    m = micro_variant("w_geo", tasks, 40, 20).method
    expect = training_launches(m, 40)
    workers = {}
    for step in (20, 39):
        with open(os.path.join(WORK, "eval_workers", f"{step}.json")) as f:
            workers[step] = json.load(f)
    card = torch.cuda.get_device_name(0)
    workers_ok = all(
        w["device"] == "cuda" and w["card"] == card and w["act_calls"] > 0
        and w["launches"] == {k: 0 for k in counters} | {
            "flash_self_attention_fwd": m.transformer_depth * w["act_calls"]}
        for w in workers.values())
    table = read_csv(os.path.join(out, "0.csv"))
    with open(os.path.join(out, "0.csv")) as f:
        header = next(csv_mod.reader(f))
    ret_cols = [c for c in header if "return" in c and "mean_return" not in c]
    avg = calculate_average_return(table)
    format_ok = ("step" in header and len(table["step"]) >= 2
                 and all(f"eval_envs/{k}/{t}" in header for t in tasks
                         for k in ("return", "length", "total_transitions"))
                 and np.isclose(avg[0], np.mean([table[c][0]
                                                 for c in ret_cols]))
                 and "step" in category_table(table))
    ok = (format_ok and workers_ok and launches == expect and acts == 0
          and m.policy_dtype == "float32" and m.latent_dim_head == 8
          and np.isfinite(summary["last"]["mean"])
          and np.isfinite(summary["best"]["mean"])
          and summary["best"]["mean"] >= summary["last"]["mean"] - 1e-9
          and sorted(os.listdir(out)) == ["0.csv", "config.json",
                                          "summary.json", "train_0.csv"])
    log("artifact", config="micro_variant(w_geo)", tasks=list(tasks),
        seeds=1, iterations=40, save_freq=20, episodes=1, workers=2,
        dtype=m.policy_dtype, heads=[m.latent_heads, m.latent_dim_head],
        latents=[m.num_latents, m.latent_dim], header=header,
        summary=summary, launches=launches, expected=expect,
        eval_workers=workers, format_ok=format_ok, seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError("the results artifact failed its checks")
    return {"launches": launches,
            "worker_launches": {k: sum(w["launches"][k]
                                       for w in workers.values())
                                for k in counters}}


def phase_tools(counters: dict) -> dict:
    """The other user scripts on the card: `gen_demonstrations` (one 128²
    episode, loaded back), `diagnose_learning` (40 micro iterations,
    `save_freq` 20, 1 episode; the counts set to 0 just before and read
    just after: the training's flash and blend pairs, then the flash
    forward of every act of the keyframe accuracy and the rollouts), and
    `make_goldens` (its oracle is `ops/rasterizer_ref.py`, the untiled
    per-pixel copy of the JAX oracle; no kernel launches): the regenerated
    fixtures against tests/goldens/*.npz on every element (loss rtol 1e-5,
    radii exact, frames atol 1e-5 rtol 1e-4, gradients rtol 1e-4 with atol
    1e-5 of the array's largest magnitude, as in
    tests/test_torch_scripts_goldens.py), and the kernel route's frames and
    gradients on the regenerated scenes against them under the golden
    tests' rule for a second implementation."""
    import numpy as np
    import torch
    from manigaussian_tpu_torch.config import micro_w_geo
    from manigaussian_tpu_torch.data.episode import (list_episodes,
                                                     load_episode,
                                                     load_image)
    from manigaussian_tpu_torch.ops.camera import novel_camera_calib
    from manigaussian_tpu_torch.ops.rasterizer import (RasterizeConfig,
                                                       rasterize)
    from manigaussian_tpu_torch.scripts import diagnose_learning as dl
    from manigaussian_tpu_torch.scripts import gen_demonstrations as gd
    from manigaussian_tpu_torch.scripts import make_goldens as mg

    t0 = time.time()
    demos = os.path.join(WORK, "tools_demos")
    gd.main(["--tasks", "open_drawer", "--save_path", demos,
             "--episodes_per_task", "1", "--image_size", "128",
             "--nerf_views", "3", "--timesteps", "12"])
    eps = list_episodes(demos, "open_drawer")
    ep = load_episode(eps[0])
    gen_ok = (len(eps) == 1 and len(ep) == 12
              and load_image(ep.rgb_paths["front"][0]).shape == (128, 128, 3)
              and len(ep.nerf_rgb_paths[0]) == 3)
    gen_s = time.time() - t0

    report, launches, acts, diag_s = run_counted(
        counters, dl.main, ["--iterations", "40", "--save-freq", "20",
                            "--episodes", "1",
                            "--work", os.path.join(WORK, "diag")])
    m = micro_w_geo(("open_drawer",), 40, 20).method
    expect = training_launches(m, 40, acts)
    diag_ok = ([r["step"] for r in report] == [20, 39] and launches == expect
               and all(np.isfinite(v) for r in report for v in r.values())
               and all(r["n"] > 0 for r in report))

    out = os.path.join(WORK, "goldens")
    golden, g_launches, _, golden_s = run_counted(counters, mg.main,
                                                  ["--out", out])
    rule = {"frames": (1e-4, 1e-3, 0.005), "grads": (2e-4, 1e-3, 0.02)}
    frames = ("golden_color", "golden_lang", "golden_final_t")

    def all_close(a, d, atol, rtol):
        a, d = np.asarray(a, np.float64), np.asarray(d, np.float64)
        return (bool(np.allclose(a, d, atol=atol, rtol=rtol)),
                float(np.abs(a - d).max()))

    g_res, g_ok = {}, g_launches == {k: 0 for k in counters}
    for name, rec in golden.items():
        want = dict(np.load(os.path.join(ROOT, "tests", "goldens",
                                         name + ".npz")))
        res = {"loss_rel": abs(float(rec["loss"]) - float(want["loss"]))
               / abs(float(want["loss"])),
               "radii_equal": bool(np.array_equal(rec["golden_radii"],
                                                  want["golden_radii"]))}
        for k in frames:
            res[k] = all_close(rec[k], want[k], 1e-5, 1e-4)
        for k in mg.PARAM_KEYS:
            g = want[f"grad_{k}"]
            res[f"grad_{k}"] = all_close(rec[f"grad_{k}"], g,
                                         1e-5 * np.abs(g).max(), 1e-4)
        # the kernel route on the regenerated scene, against the regenerated
        h, w = int(rec["height"]), int(rec["width"])
        n = rec["means3d"].shape[0]
        t = lambda a: torch.tensor(np.asarray(a), device="cuda")
        cam = novel_camera_calib(t(rec["intrinsic"]), t(rec["c2w"]),
                                 float(rec["znear"]), float(rec["zfar"]), h, w)
        cfg = RasterizeConfig(width=w, height=h, tile=16,
                              max_tiles_per_gaussian=(h // 16) * (w // 16),
                              tile_capacity=max(256, ((n + 127) // 128) * 128),
                              chunk=128, sh_degree=1, backend="pallas")
        wc, wl, wt = (t(x) for x in mg.loss_weights(h, w))
        p = {k: t(rec[k]).requires_grad_() for k in mg.PARAM_KEYS}
        before = {k: c.launches for k, c in counters.items()}
        kout, _ = rasterize(p["means3d"], p["opacities"], cam, cfg,
                            (0.0, 0.0, 0.0), p["scales"], p["rotations"],
                            p["shs"], p["language_features"])
        (torch.sum(kout.color.reshape(-1, 3) * wc)
         + torch.sum(kout.language_feature.reshape(-1, 3) * wl)
         + torch.sum(kout.final_t.reshape(-1) * wt)).backward()
        torch.cuda.synchronize()
        k_launch = {k: c.launches - before[k] for k, c in counters.items()}
        for k, f in zip(frames, ("color", "language_feature", "final_t")):
            res[f"kernel_{k}"] = mostly_close(
                getattr(kout, f).detach().cpu(), rec[k], *rule["frames"])
        for k in mg.PARAM_KEYS:
            res[f"kernel_grad_{k}"] = mostly_close(
                p[k].grad.cpu(), rec[f"grad_{k}"], *rule["grads"])
        g_ok = (g_ok and res["loss_rel"] <= 1e-5 and res["radii_equal"]
                and all(v[0] for v in res.values() if isinstance(v, tuple))
                and k_launch["blend_fwd"] == 1 and k_launch["blend_bwd"] == 1)
        g_res[name] = res
    ok = gen_ok and diag_ok and g_ok
    log("tools", gen_demonstrations={"episodes": len(eps), "steps": len(ep),
                                     "seconds": gen_s, "ok": gen_ok},
        diagnose_learning={"report": report, "act_calls": acts,
                           "launches": launches, "expected": expect,
                           "seconds": diag_s, "ok": diag_ok},
        make_goldens={"oracle": "ops/rasterizer_ref.py",
                      "launches": g_launches, "results": g_res,
                      "rule": "against tests/goldens, every element: loss "
                              "rtol 1e-5, radii exact, frames atol 1e-5 "
                              "rtol 1e-4, grads rtol 1e-4 atol 1e-5 x max; "
                              "kernel route against the regenerated: frames "
                              "atol 1e-4 rtol 1e-3 <=0.5 % outside, grads "
                              "atol 2e-4 rtol 1e-3 <=2 % outside",
                      "seconds": golden_s, "ok": g_ok},
        seconds=time.time() - t0, ok=ok)
    if not ok:
        raise AssertionError("the user tools failed their checks")
    return {"launches": launches}


def main(argv) -> int:
    if argv not in ([], ["--flash-times"], ["--blend-times"], ["--embed-ab"],
                    ["--conv-times"], ["--gnf-steps"], ["--step-times"]):
        print(f"chip_smoke: unknown arguments {argv}; takes none, "
              "--flash-times, --blend-times, --conv-times, --embed-ab, "
              "--gnf-steps or --step-times", file=sys.stderr)
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
    if argv == ["--conv-times"]:
        # the dW kernels' times alone, for the same kind of A/B
        phase_build()
        conv_times()
        return 0
    if argv == ["--step-times"]:
        # the one-process step and act alone, for the same kind of A/B
        phase_build()
        step_times()
        return 0
    if argv == ["--gnf-steps"]:
        # GNFACTOR_BC's first steps at full width, card against CPU
        phase_build()
        gnf_steps()
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
    phase_dino_dir()
    dp = phase_dp_slice(tr["demos"])
    ev = phase_eval_slice(counters, sl)
    rp = phase_eval_rpc(counters, sl, ev)
    ad = phase_adam_slice(counters, tr["demos"], tr["step_ms"])
    dk = phase_disk_slice(counters, tr["demos"])
    tl = phase_two_level(counters)
    phase_dino_swiglu()
    phase_towers_msgpack()
    it = phase_imported_train(counters, tr)
    sc = phase_scaling(counters)
    phase_extras()
    cp = phase_campaign(counters)
    ar = phase_artifact(counters)
    tl_ = phase_tools(counters)
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
             "act_gnfactor_bc": gn["act_launches"],
             **{f"train_w_geo_{run}_rank0": c
                for run, c in dp["launches"].items()},
             "eval_w_geo_serial": ev["launches"],
             "eval_w_geo_workers2": ev["worker_launches"],
             "eval_w_geo_rpc": rp["launches"],
             "eval_w_geo_transcript": rp["transcript_launches"],
             "train_w_geo_adam": ad["launches"],
             "train_w_geo_native_replay": dk["launches"],
             "render_two_level": tl["launches"],
             "train_w_geo_imported": it["launches"], **sc["launches"],
             "campaign_w_geo": cp["launches"],
             "artifact_micro": ar["launches"],
             "artifact_micro_eval_workers2": ar["worker_launches"],
             "diagnose_micro": tl_["launches"]}
    # every kernel of a dp_slice run's path (the flash and blend pairs) was
    # launched there (phase_dp_slice also holds each rank to its count)
    for run, c in dp["launches"].items():
        idle = [k for k in ("flash_self_attention_fwd",
                            "flash_self_attention_bwd", "blend_fwd",
                            "blend_bwd") if not c.get(k)]
        if idle:
            raise AssertionError(f"dp_slice {run} never launched {idle}")
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
