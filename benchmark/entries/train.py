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
parameters before the first and after the third, LAMB's first moment and
the parameters' change after the first; of the first, the self-attention
blocks' outputs, each flash call's operands with the gradients its
backward got and gave, and the NeRF's ray outputs), and after the window
the plain reference follows them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np

from ..correct import aligned_gap, flash_backward_gap, kept_gaps, \
    lamb_step_gaps, training_numbers
from ..reference import data as ref_data
from ..reference import strict_float32
from ..reference import foundation as ref_foundation
from ..reference import nerf_renderer as ref_nerf
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


@contextlib.contextmanager
def attention_kept(qnet, into: List):
    """While open, each self-attention layer's output (float32, on the
    host) goes into `into`, layer by layer: the program's and the
    reference's policies have the same `self_attn` blocks."""
    def keep(_module, _args, out):
        into.append(out.detach().float().cpu().numpy())
    hooks = [blk.attn.register_forward_hook(keep) for blk in qnet.self_attn]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def rays_kept(renderer_cls, into: List):
    """While open, each NeRF render's coarse and fine colour and embedding
    of its rays (float32, on the host) go into `into`: the program's and
    the reference's `render_rays` give the same (coarse, fine)."""
    render_rays = renderer_cls.render_rays

    def keeping(self, *a, **k):
        coarse, fine = render_rays(self, *a, **k)
        into.extend(x.detach().float().cpu().numpy()
                    for o in (coarse, fine) for x in (o.rgb, o.embed))
        return coarse, fine

    renderer_cls.render_rays = keeping
    try:
        yield
    finally:
        renderer_cls.render_rays = render_rays


@contextlib.contextmanager
def flash_calls_kept(torch, into: List):
    """While open, each call of the policy's flash self-attention goes into
    `into`: its operands q, k, v (on the host, in their dtype), its dropout
    rate, seed and block, and, once the backward has run, the gradient of
    its output (`dout`) and the dq, dk, dv the backward gave for it (read
    by tensor hooks on views that only the call uses)."""
    import manigaussian_tpu_torch.models.perceiver as P
    attend = P.flash_self_attention
    host = lambda t: t.detach().cpu()

    def keeping(q, k, v, dropout_rate=0.0, dropout_seed=None, block_q=256,
                **kw):
        rec = {"rate": float(dropout_rate), "block_q": int(block_q),
               "seed": (None if dropout_seed is None else
                        int(torch.as_tensor(dropout_seed).reshape(-1)[0])),
               "q": host(q), "k": host(k), "v": host(v)}

        def store(key):
            return lambda g: rec.__setitem__(key, host(g))

        ins = [t.view_as(t) for t in (q, k, v)]
        for key, t in zip(("dq", "dk", "dv"), ins):
            if t.requires_grad:
                t.register_hook(store(key))
        out = attend(*ins, dropout_rate=dropout_rate,
                     dropout_seed=dropout_seed, block_q=block_q, **kw)
        if out.requires_grad:
            out.register_hook(store("dout"))
        into.append(rec)
        return out

    P.flash_self_attention = keeping
    try:
        yield
    finally:
        P.flash_self_attention = attend


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
    from manigaussian_tpu_torch.rendering.nerf_renderer import \
        GNFactorNeRFRenderer
    warm = ctx.workload["warmup_steps"]
    i = 0
    while i < warm:
        batch = next(batches)
        if i < FOLLOWED and any(_same_row(batch, r) for r in st["rows"]):
            continue            # the followed steps' rows all differ
        if i < FOLLOWED:
            st["rows"].append(batch)
            st["states"].append(gen.get_state())
        with contextlib.ExitStack() as kept:
            if i == 0:
                kept.enter_context(attention_kept(agent.qfn.qnet,
                                                  st.setdefault("attn_out", [])))
                kept.enter_context(flash_calls_kept(
                    torch, st.setdefault("flash_calls", [])))
                kept.enter_context(rays_kept(GNFactorNeRFRenderer,
                                             st.setdefault("nerf_rays", [])))
            metrics = ctx.step(agent, batch, gen)
        if i < FOLLOWED:
            st["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            b1 = agent.opt.b1
            st["grad_norms"] = _norms(torch, [m / (1.0 - b1)
                                              for m in agent.opt.mu])
            # copies (on the CPU `.cpu()` would alias the live state)
            host = lambda ts: [t.detach().to("cpu", copy=True) for t in ts]
            st["lamb"] = {"p0": host(p0), "m": host(agent.opt.mu),
                          "delta": [(p.detach() - q).cpu()
                                    for p, q in zip(params, p0)]}
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
    """The reference's (or with `compute`, the control's or the witness's)
    readings over the followed steps: losses, the first gradient's leaf
    norms, the change's leaf norms over the three steps, the first step's
    self-attention and NeRF outputs."""
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
        with contextlib.ExitStack() as kept:
            if s == 0:
                kept.enter_context(attention_kept(
                    ref.qfn.qnet, out.setdefault("attn_out", [])))
                kept.enter_context(rays_kept(ref_nerf.GNFactorNeRFRenderer,
                                             out.setdefault("nerf_rays", [])))
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


def backward_checked(ctx, st) -> Dict:
    """The program's side with `attn_bwd`, its flash backward against the
    float64 gradient, and `lamb_step`, its first LAMB update against the
    reference's (the kept calls and states then go)."""
    gap = flash_backward_gap(ctx.torch, st.pop("flash_calls", ()), ctx.device)
    lamb = lamb_step_gaps(ctx.torch, st.pop("lamb"), ctx.cfg.method,
                          ctx.device)
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()
    st["lamb_gaps"] = lamb
    return dict(st, attn_bwd=gap, lamb_step=max(lamb, default=0.0))


def diagnostics(st, ref, leaves: bool = False) -> Dict:
    """The initial weights' largest gap of leaf norms (0: both sides drew
    the same weights), the leaves with the widest gaps (of the first
    gradient, of the change and of the first LAMB update), each step's
    losses; with `leaves`, every leaf's norms (calibration reads them)."""
    from ..correct import kept_leaves, leaf_gaps
    keep = kept_leaves(ref["grad_norms"])
    out = {"init_gap": max(abs(a - b) for a, b in
                           zip(st["init_norms"], ref["init_norms"]))}
    per_leaf = {key: leaf_gaps(st[key + "_norms"], ref[key + "_norms"], keep)
                for key in ("grad", "change")}
    if "lamb_gaps" in st:
        per_leaf["lamb"] = st["lamb_gaps"]
    for key, gaps in per_leaf.items():
        top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
        out[key + "_worst"] = [(st["names"][i], gaps[i]) for i in top]
    out["leaves_left_out"] = [n for n, k in zip(st["names"], keep) if not k]
    out["attn_layers"] = kept_gaps(st, ref, "attn_out")
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
        side = backward_checked(ctx, st)
        ref = follow(ctx, st)
        wit = follow(ctx, st, witness_compute(ctx))
    except LookupError as e:    # the feed made a batch of no transition
        out["diagnostics"] = {"error": str(e)}
        return out
    out["numbers"] = training_numbers(side, ref, wit, st["names"])
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
    side = backward_checked(ctx, st)
    ref = follow(ctx, st)
    wit = follow(ctx, st, witness_compute(ctx))
    if compute is not None:
        side = dict(follow(ctx, st, compute), names=st["names"])
    return {"numbers": training_numbers(side, ref, wit, st["names"]),
            "diagnostics": diagnostics(side, ref, leaves=True)}
