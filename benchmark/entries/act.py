"""The act cell's loop: one caller at batch 1 with no think time, each call
`ManiGaussianBCAgent.act(observation)` with the action copied to the host
before the next call, as the evaluation's rollout does (runners/
eval_runner.rollout_episode). The observations are the traffic's frames:
the front RGB and its point cloud, the low-dim state and the language
embeddings, in an order drawn from the seed and cycled.

After the window every act of the window is checked against the plain
reference's Q-values on its observation (one reference forward a distinct
frame, every frame of the traffic).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..correct import action_gap
from ..reference import data as ref_data
from ..reference import strict_float32
from ..reference.agent import ReferenceAgent
from ..traffic.generator import make_episodes


def observations(ctx) -> List[Dict[str, np.ndarray]]:
    """Every frame of the traffic's episodes as a batched observation."""
    torch = ctx.torch
    out = []
    for ep in make_episodes(ctx.seed, **ctx.traffic["episodes"]):
        for t in range(ep["front_rgb"].shape[0]):
            obs = ref_data.observation(ep, t, torch.device("cpu"))
            out.append({k: v.numpy() for k, v in obs.items()})
    return out


def setup(ctx) -> Dict:
    torch = ctx.torch
    from manigaussian_tpu_torch.agents.registry import create_agent

    obs = observations(ctx)
    ctx.lap("frames")
    order = np.random.default_rng(ctx.seed).permutation(len(obs))
    agent = create_agent(ctx.cfg_port, device=ctx.device, seed=ctx.seed)
    ctx.lap("agent")
    st = dict(agent=agent, obs=obs, order=order, next=0, done=[])
    for _ in range(ctx.workload["warmup_steps"]):
        act(ctx, st)
    ctx.sync()
    ctx.lap("warm-up acts")
    st["next"] = 0
    return st


def act(ctx, st):
    """One act on the next frame; its answer is kept for the check."""
    f = int(st["order"][st["next"] % len(st["order"])])
    st["next"] += 1
    res = ctx.act(st["agent"], st["obs"][f])
    res.continuous_action[0].cpu().numpy()
    st["done"].append((f, res.trans_coords, res.rot_grip_indices,
                       res.collision_indices))


def window(ctx, st) -> Dict:
    times = []
    st["done"] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        ta = time.perf_counter()
        act(ctx, st)
        times.append(time.perf_counter() - ta)
    elapsed = time.perf_counter() - t0
    ms = np.asarray(times) * 1e3
    return {"acts": len(times), "elapsed_s": elapsed,
            "act_ms_p50": float(np.percentile(ms, 50)),
            "act_ms_p95": float(np.percentile(ms, 95)),
            "call_ms_mean": elapsed / len(times) * 1e3}


def close(ctx, st) -> None:
    """Every kept answer to the host (the window's, or calibration's)."""
    torch = ctx.torch
    v = ctx.cfg.method.voxel_sizes[0]
    st["checked"] = []
    for f, coords, rot_grip, coll in st["done"]:
        c = coords[0].cpu().tolist()
        rg = rot_grip[0].cpu().tolist()
        st["checked"].append((f, (c[0] * v + c[1]) * v + c[2], rg[:3], rg[3],
                              int(coll[0, 0])))
    for k in ("agent", "done"):
        st.pop(k, None)
    import gc
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_q(ctx, st, frames, compute=None) -> Dict:
    """The reference's (or with `compute`, the control's) Q-values on each
    of `frames`, on the host."""
    torch = ctx.torch
    with strict_float32(torch):
        ref = ReferenceAgent(ctx.cfg, ctx.device, ctx.seed, compute)
        q = {}
        for f in sorted(set(frames)):
            obs = {k: torch.as_tensor(v).to(ctx.device)
                   for k, v in st["obs"][f].items()}
            q[f] = tuple(x.cpu() for x in ref.q_values(obs))
        del ref
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return q


def follow(ctx, st) -> Dict[str, float]:
    """The widest gap of every checked act against the reference."""
    q = reference_q(ctx, st, [c[0] for c in st["checked"]])
    answers = {(f, trans, tuple(rots), grip, coll)
               for f, trans, rots, grip, coll in st["checked"]}
    worst = max(action_gap(ctx.torch, q[f], (trans, rots, grip, coll))
                for f, trans, rots, grip, coll in answers)
    return {"action": worst, "acts_checked": len(st["checked"]),
            "frames_checked": len(q)}


def chosen(torch, qs):
    """The indices a set of Q-values picks (the control's answer)."""
    q_trans, q_rg, q_coll = (x[0] for x in qs)
    nrot = (q_rg.shape[0] - 2) // 3
    rots = [int(q_rg[i * nrot:(i + 1) * nrot].argmax()) for i in range(3)]
    return (int(q_trans.argmax()), rots, int(q_rg[3 * nrot:].argmax()),
            int(q_coll.argmax()))


def run(ctx) -> Dict:
    st = setup(ctx)
    ctx.mark_setup()
    win = window(ctx, st)
    out = {"attempted": win["acts"], "failed": 0,
           "e2e": {"act_ms_p50": win["act_ms_p50"],
                   "act_ms_p95": win["act_ms_p95"]},
           "record": {"host": win, "training": False}}
    ctx.read_peak()
    if ctx.trace:
        from ..trace import profile_calls
        out["record"].update(profile_calls(
            ctx.torch, lambda: act(ctx, st), ctx.workload["traced_steps"],
            ctx.sync))
    close(ctx, st)
    out["numbers"] = follow(ctx, st)
    return out


def calibrate(ctx, compute=None) -> Dict:
    """The check's numbers without a window: one act of the program on
    every frame (or with `compute`, the control's picks on every frame)
    against the reference."""
    st = setup(ctx)
    st["done"] = []
    for _ in range(len(st["obs"])):
        act(ctx, st)
    close(ctx, st)
    if compute is not None:
        q = reference_q(ctx, st, [c[0] for c in st["checked"]], compute)
        st["checked"] = [(f, *chosen(ctx.torch, q[f])) for f in sorted(q)]
    return {"numbers": follow(ctx, st)}
