"""Chip smoke test of the PyTorch/CUDA port (`manigaussian_tpu_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1. build   — compile every CUDA source of the port with nvcc (sm_90a), in
               parallel, and print the build time and ptxas's register report;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at the main path's shapes (and a few more), then time the
               kernel, the plain version and the PyTorch library call that
               computes the same function (a yardstick only; the port never
               calls it);
  3. small   — references on small inputs, the card against the CPU (the
               plain versions, which tests/test_torch_*.py hold to the JAX
               package): voxelize with points on cell boundaries (same
               cells, 1e-6, bitwise repeatable on the card); the micro
               config's act with the same weights in fp32 (zero and edge
               padding: Q-values within 1e-3, same discrete action) and in
               bf16 (the route rule below);
  4. slice   — the act/eval path at the full width of `config.w_geo()`
               (V=100, 2048×512 latents, 6 layers of 8×64 heads, bf16, one
               128² front camera), random weights from seed 0: synthetic
               demos, a saved checkpoint, then the port's eval entry point
               (`manigaussian_tpu_torch.eval.main`) on the mock env, 2
               episodes × up to 5 steps. Every kernel count is set to 0 just
               before that run and read just after; the flash kernel must
               have launched exactly `transformer_depth` times per act call;
  5. routes  — the same observation through the kernel route
               (policy_attn_impl="flash") and the plain route ("xla"): Q
               values within the bf16 tolerance below, act latency (median
               of 12 calls after 3 warm-up calls, alternating the routes)
               and peak device memory of one act call on each route;
  6. profile — torch.profiler over act calls on the kernel route: device
               busy share and the kernels and ops that take the time.
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

# The kernel route and the plain route differ only in where bf16 rounds
# inside attention (unnormalized vs normalized probabilities, summation
# order); through 6 residual layers, the decoder and the 100³ convs that
# stays a few bf16 steps (2^-8 relative each) of the Q-values' scale.
ROUTE_TOL = 5e-2


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from manigaussian_tpu_torch.ops.flash_attention import (
        flash_self_attention, flash_self_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = [("bfloat16", 2048, 64, 2e-2), ("float32", 2048, 64, 1e-5),
              ("bfloat16", 256, 64, 2e-2), ("bfloat16", 512, 64, 2e-2),
              ("float32", 512, 64, 1e-5), ("bfloat16", 100, 16, 2e-2),
              ("float32", 32, 8, 1e-5)]
    record = None
    for dtype, n, d, tol in checks:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(1, 8, n, d, generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        bq = 256 if n % 256 == 0 else n
        out = flash_self_attention(q, k, v, block_q=bq)
        ref = flash_self_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= tol
        log("kernel_check", kernel="flash_self_attention", dtype=dtype,
            shape=[1, 8, n, d], max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"flash kernel disagrees: {dtype} n={n} d={d} "
                                 f"err={err} tol={tol}")
        if (dtype, n, d) == ("bfloat16", 2048, 64):
            bh = q.shape[0] * q.shape[1]
            flops = 4.0 * bh * n * n * d
            nbytes = 4.0 * bh * n * d * q.element_size()
            bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
            times = {
                "ms": cuda_ms(lambda: flash_self_attention(q, k, v)),
                "plain_ms": cuda_ms(lambda: flash_self_attention_reference(q, k, v)),
                "library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v)),
            }
            record = {
                "name": "flash_self_attention_fwd", "route": "cuda",
                "source": "manigaussian_tpu_torch/csrc/flash_attention.cu",
                "replaces": "manigaussian_tpu/ops/flash_attention.py:138",
                "launches": None, "max_abs_err": err, **times,
                "bound_ms": bound_ms,
                "bound_by": ("operations" if flops / PEAK_FLOPS[dtype]
                             >= nbytes / PEAK_BYTES else "bytes"),
            }
            log("kernel_time", kernel="flash_self_attention", shape=[1, 8, n, d],
                dtype=dtype, flops=flops, bytes=nbytes, **times,
                bound_ms=bound_ms, bound_by=record["bound_by"],
                tflops=flops / times["ms"] / 1e9)
    return record


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
    phase_profile(agents["flash"], obs)


def phase_profile(agent, obs, calls: int = 3) -> None:
    """Where one act call's time goes: torch.profiler over `calls` act calls
    on the kernel route — wall time, summed kernel time (the device's busy
    share, one stream), the kernels and the aten ops with the most device
    time, all per act call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    agent.act(obs).continuous_action.cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            agent.act(obs).continuous_action.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls

    def rows(evs, attr, n=12):
        return [[e.key[:90], round(getattr(e, attr) / 1e3 / calls, 4),
                 e.count / calls] for e in evs[:n]]

    log("profile", route="flash", calls=calls, wall_ms_per_act=wall_ms,
        kernel_ms_per_act=device_ms,
        device_busy_share=device_ms / wall_ms if wall_ms else None,
        kernels_launched_per_act=sum(e.count for e in kernels) / calls,
        top_kernels_ms_count=rows(kernels, "self_device_time_total"),
        top_aten_ops_device_ms_count=rows(ops, "device_time_total"))


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
        from manigaussian_tpu_torch.ops.flash_attention import \
            flash_self_attention
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    counters = {"flash_self_attention_fwd": flash_self_attention}

    t_start = time.time()
    phase_build()
    record = phase_kernels()
    phase_small()
    sl = phase_slice(counters)
    phase_routes(sl["cfg"], sl["logdir"], sl["demos"])
    record["launches"] = sl["launches"]["flash_self_attention_fwd"]
    log("done", seconds=round(time.time() - t_start, 3))

    print(json.dumps({"kernels": [record]}))
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
