"""The training cells' loop: the offline runner's per-step body,
`next(batches)` from the port's `BatchIterator` and
`ManiGaussianBCAgent.update(batch, generator)`, the metrics read on the
host every `framework.log_freq` steps, at batch 1 (runners/
offline_train_runner.py). The runner's checkpoint and recon panel are left
out of the window.

Set-up: the traffic's demonstrations are written from the seed, the
program fills its replay from them, builds the agent from the seed (and,
in the semantic tiers, the frozen tower in the prefetch thread), and moves
the agent's step to the cell's `start_step` (a resumed run's gate). The
first steps go through the window's own call and feed; the first three
are recorded (their batches, the generator's state before each, the
parameters before the first and after the third, LAMB's first moment after
the first), and after the window the plain reference follows them.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from ..correct import aligned_gap, training_numbers
from ..reference import data as ref_data
from ..reference import strict_float32
from ..reference import foundation as ref_foundation
from ..reference.agent import ReferenceAgent
from ..traffic.generator import make_episodes

FOLLOWED = 3


def _same_row(a: Dict, b: Dict) -> bool:
    keys = ("rgb", "low_dim_state", "gripper_pose", "nerf_target_rgb",
            "nerf_next_target_rgb")
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in keys if k in a)


def _norms(torch, tensors) -> List[float]:
    return torch.stack([torch.linalg.norm(t.reshape(-1).double())
                        for t in tensors]).cpu().tolist()


def setup(ctx) -> Dict:
    """The program's set-up up to the window; returns its state and the
    records of the followed steps."""
    torch = ctx.torch
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import BatchIterator, fill_replay
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay

    cfg, mix = ctx.cfg_port, ctx.traffic
    demos = os.path.join(ctx.work, "demos")
    episodes = make_episodes(ctx.seed, root=demos, **mix["episodes"])
    ctx.lap("demonstrations")
    task = mix["episodes"]["task"]
    lang = create_language_model(
        cfg.method.language_model,
        checkpoint_dir=cfg.method.language_model_checkpoint,
        cache_dir=os.path.join(ctx.work, "lang_cache"), device=ctx.device)
    replay = TaskUniformReplay(
        save_dir=cfg.replay.path if cfg.replay.use_disk else None)
    fill_replay(replay, demos, task, mix["episodes"]["episodes"],
                cfg.rlbench.cameras, cfg.rlbench.scene_bounds,
                cfg.method.voxel_sizes[0], cfg.method.rotation_resolution,
                cfg.rlbench.episode_length, lang,
                demo_augmentation=cfg.method.demo_augmentation,
                demo_augmentation_every_n=cfg.method.demo_augmentation_every_n,
                keypoint_method=cfg.method.keypoint_method)
    replay.flush()
    ctx.lap("replay")
    agent = create_agent(cfg, device=ctx.device, seed=ctx.seed)
    agent.step = ctx.workload["start_step"]
    ctx.lap("agent")
    nr = cfg.method.neural_renderer
    embed_fn = None
    if nr.foundation_model_name and cfg.method.use_neural_rendering:
        from manigaussian_tpu_torch.models.foundation import \
            create_feature_extractor
        embed_fn = create_feature_extractor(
            nr.foundation_model_name, nr.foundation_checkpoint,
            device=agent.device).embed_fn(nr.d_embed)
    batches = BatchIterator(replay, cfg.replay.batch_size, seed=ctx.seed,
                            num_view_for_nerf=cfg.method.num_view_for_nerf,
                            load_nerf_targets=cfg.method.use_neural_rendering,
                            embed_fn=embed_fn)
    ctx.lap("tower and feed")
    gen = torch.Generator().manual_seed(ctx.seed + 1)
    st = dict(agent=agent, batches=batches, gen=gen, episodes=episodes,
              rows=[], states=[], losses=[], start_step=agent.step)
    st["names"] = [n for n, _ in agent.qfn.named_parameters()]
    params = list(agent.qfn.parameters())
    p0 = [p.detach().clone() for p in params]
    st["init_norms"] = _norms(torch, p0)
    warm = ctx.workload["warmup_steps"]
    i = 0
    while i < warm:
        batch = next(batches)
        if i < FOLLOWED and any(_same_row(batch, r) for r in st["rows"]):
            continue            # the followed steps' rows all differ
        if i < FOLLOWED:
            st["rows"].append(batch)
            st["states"].append(gen.get_state())
        metrics = ctx.step(agent, batch, gen)
        if i < FOLLOWED:
            st["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            b1 = agent.opt.b1
            st["grad_norms"] = _norms(torch, [m / (1.0 - b1)
                                              for m in agent.opt.mu])
        if i == FOLLOWED - 1:
            st["change_norms"] = _norms(
                torch, [p.detach() - q for p, q in zip(params, p0)])
            del p0
        i += 1
    ctx.sync()
    ctx.lap("warm-up steps")
    return st


def window(ctx, st) -> Dict:
    torch = ctx.torch
    agent, batches, gen = st["agent"], st["batches"], st["gen"]
    log_freq = ctx.cfg_port.framework.log_freq
    steps, wait, issued = 0, 0.0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        tw = time.perf_counter()
        batch = next(batches)
        wait += time.perf_counter() - tw
        metrics = ctx.step(agent, batch, gen)
        if steps % log_freq == 0:
            host = {k: float(v) for k, v in metrics.items()}
            if not np.isfinite(host["total_loss"]):
                st["failed"] = st.get("failed", 0) + 1
        steps += 1
        issued.append(time.perf_counter() - t0)
    ctx.sync()
    elapsed = time.perf_counter() - t0
    return {"steps": steps, "elapsed_s": elapsed, "issued_s": issued,
            "call_ms_mean": elapsed / steps * 1e3,
            "feed_wait_ms": wait / steps * 1e3}


def traced(ctx, st, calls: int) -> Dict:
    from ..trace import profile_calls
    agent, batches, gen = st["agent"], st["batches"], st["gen"]
    return profile_calls(ctx.torch, lambda: ctx.step(agent, next(batches), gen),
                         calls, ctx.sync)


def close(ctx, st) -> None:
    st["batches"].close()
    for k in ("agent", "batches", "gen"):
        st.pop(k, None)
    import gc
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def follow(ctx, st, compute=None) -> Dict:
    """The reference's (or with `compute`, the control's) readings over the
    followed steps: losses, the first gradient's leaf norms, the change's
    leaf norms over the three steps."""
    with strict_float32(ctx.torch):
        return _follow(ctx, st, compute)


def _follow(ctx, st, compute) -> Dict:
    torch = ctx.torch
    cfg = ctx.cfg
    ref = ReferenceAgent(cfg, ctx.device, ctx.seed, compute)
    trans = ref_data.transitions(st["episodes"], cfg)
    nr = cfg.method.neural_renderer
    tower = (ref_foundation.sd_vae_tower(ctx.device)
             if nr.foundation_model_name == "diffusion" else None)
    params = list(ref.qfn.parameters())
    p0 = [p.detach().clone() for p in params]
    out = {"init_norms": _norms(torch, p0), "losses": []}
    for s, (batch, state) in enumerate(zip(st["rows"], st["states"])):
        row = ref_data.match(batch, st["episodes"], trans,
                             cfg.method.num_view_for_nerf)
        if row is None:
            raise LookupError(f"step {s}: the feed's batch is no transition "
                              "of the demonstrations")
        b = ref_data.inputs(row, st["episodes"], ctx.device)
        if tower is not None:
            b["gt_embed"] = ref_foundation.gt_embed(tower, b["nerf_target_rgb"],
                                                    nr.d_embed)
            prog = torch.as_tensor(np.asarray(batch["gt_embed"]),
                                   device=ctx.device).double()
            ref_e = b["gt_embed"].double()
            plain = float(torch.linalg.norm(prog - ref_e)
                          / torch.linalg.norm(ref_e))
            out["gt_embed"] = max(out.get("gt_embed", 0.0),
                                  aligned_gap(torch, prog, ref_e))
            out["gt_embed_plain"] = max(out.get("gt_embed_plain", 0.0), plain)
        gen = torch.Generator()
        gen.set_state(state)
        out["losses"].append(ref.update(b, gen, st["start_step"] + s))
        ref.opt.step()
        if s == 0:
            out["grad_norms"] = _norms(torch, [m / (1.0 - ref.opt.b1)
                                               for m in ref.opt.mu])
    out["change_norms"] = _norms(torch, [p.detach() - q
                                         for p, q in zip(params, p0)])
    del ref, tower, p0, params
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def witness_compute(ctx):
    """The configuration's own precision of the policy's products."""
    return getattr(ctx.torch, ctx.cfg.method.policy_dtype)


def diagnostics(st, ref, leaves: bool = False) -> Dict:
    """The initial weights' largest gap of leaf norms (0: both sides drew
    the same weights), the leaves with the widest gaps, each step's losses;
    with `leaves`, every leaf's norms (calibration reads them)."""
    from ..correct import kept_leaves, leaf_gaps
    keep = kept_leaves(ref["grad_norms"])
    out = {"init_gap": max(abs(a - b) for a, b in
                           zip(st["init_norms"], ref["init_norms"]))}
    for key in ("grad", "change"):
        gaps = leaf_gaps(st[key + "_norms"], ref[key + "_norms"], keep)
        top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
        out[key + "_worst"] = [(st["names"][i], gaps[i]) for i in top]
    out["leaves_left_out"] = [n for n, k in zip(st["names"], keep) if not k]
    out["losses"] = {"program": st["losses"], "reference": ref["losses"]}
    if leaves:
        out["leaves"] = {"names": st["names"], "keep": keep,
                         "grad": [st["grad_norms"], ref["grad_norms"]],
                         "change": [st["change_norms"], ref["change_norms"]]}
    return out


def run(ctx) -> Dict:
    st = setup(ctx)
    ctx.mark_setup()
    win = window(ctx, st)
    out = {"attempted": win["steps"], "failed": st.get("failed", 0),
           "e2e": {"train_step_ms": win["call_ms_mean"]},
           "record": {"host": win, "training": True}}
    ctx.read_peak()
    if ctx.trace:
        out["record"].update(traced(ctx, st, ctx.workload["traced_steps"]))
    close(ctx, st)
    try:
        ref = follow(ctx, st)
        wit = follow(ctx, st, witness_compute(ctx))
    except LookupError as e:    # the feed made a batch of no transition
        out["diagnostics"] = {"error": str(e)}
        return out
    out["numbers"] = training_numbers(st, ref, wit, st["names"])
    out["diagnostics"] = dict(diagnostics(st, ref),
                              window_quarters_ms=quarters(win["issued_s"]))
    return out


def quarters(issued) -> List[float]:
    """The mean step time (ms, host clock at issue) of each quarter of the
    window: a drift within the run shows here."""
    if len(issued) < 8:
        return []
    t = np.asarray([0.0] + list(issued))
    cut = np.linspace(0, len(issued), 5).astype(int)
    return [float((t[b] - t[a]) / (b - a) * 1e3)
            for a, b in zip(cut[:-1], cut[1:])]


def calibrate(ctx, compute=None) -> Dict:
    """The check's numbers without a window: the program's (or with
    `compute`, the control's in its place) against the reference's."""
    ctx.workload = dict(ctx.workload, warmup_steps=FOLLOWED)
    st = setup(ctx)
    close(ctx, st)
    ref = follow(ctx, st)
    wit = follow(ctx, st, witness_compute(ctx))
    side = st
    if compute is not None:
        side = dict(follow(ctx, st, compute), names=st["names"])
    return {"numbers": training_numbers(side, ref, wit, st["names"]),
            "diagnostics": diagnostics(side, ref, leaves=True)}
