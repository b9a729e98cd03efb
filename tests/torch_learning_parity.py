"""Learning parity of the port against the JAX package on the CPU, at the
micro `w_geo` width (fp32, dropout 0), to tell a defect from the two
packages' random streams.

* `init_stats`: each package's own initializer (flax `init_state` from
  PRNGKey(seed), the port's `initialize` from a torch generator of the same
  seed) over a few seeds: per leaf, the mean and the standard deviation of
  the values pooled over the seeds, and each init's step-0 metrics on one
  batch with JAX's augmentation draws.
* `trajectories`: `steps` updates of both packages from the same weights
  (JAX's init of seed 0, converted) on the same cycle of seeded batches with
  JAX's draws: the metrics step by step; and, as the control for how fast
  float32 rounding alone parts two runs, JAX again from those weights with
  each nonzero value moved by one ulp (its sign drawn from seed 1, 2, …;
  `controls` such runs).

Run as a script to print both as one JSON object:

    JAX_PLATFORMS=cpu python -m tests.torch_learning_parity --steps 100 \\
        --controls 2 --seeds 4 --out build/learning_parity.json
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from manigaussian_tpu.agents.bc_agent import ManiGaussianBCAgent as JAgent
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.agents.bc_agent import \
    ManiGaussianBCAgent as TAgent
from tests.test_torch_train import jax_draws, make_batch, micro_cfg
from tests.torch_port_helpers import torch_config

N_BATCHES = 4


def _jax_init(jagent, batch, seed):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jagent.init_state(jax.random.PRNGKey(seed), jb)


def init_stats(seeds=(0, 1, 2, 3)):
    """{"leaves": {name: {"jax": [mean, std], "port": [mean, std],
    "size": n}}, "step0": {"jax": [metrics per seed], "port": [...]}}."""
    cfg = micro_cfg()
    jagent = JAgent(cfg)
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    update = jax.jit(jagent.update)
    pooled = {"jax": {}, "port": {}}
    step0 = {"jax": [], "port": []}
    for seed in seeds:
        state = _jax_init(jagent, batch, seed)
        sd = convert.qfunction_state_dict(jax.device_get(state.params))
        tagent = TAgent(torch_config(cfg), device="cpu", seed=seed)
        for name, v in sd.items():
            pooled["jax"].setdefault(name, []).append(v.numpy().ravel())
        for name, v in tagent.qfn.state_dict().items():
            pooled["port"].setdefault(name, []).append(
                v.detach().numpy().ravel().copy())
        key = jax.random.PRNGKey(100 + seed)
        _, m = update(state, jb, key)
        step0["jax"].append({k: float(x) for k, x in m.items()})
        out = tagent.update(batch, torch.Generator().manual_seed(0),
                            draws=jax_draws(cfg, key, 2))
        step0["port"].append({k: float(x) for k, x in out.items()})
    leaves = {}
    for name in pooled["jax"]:
        row = {"size": int(pooled["jax"][name][0].size)}
        for pkg in ("jax", "port"):
            x = np.concatenate(pooled[pkg][name]).astype(np.float64)
            row[pkg] = [float(x.mean()), float(x.std())]
        leaves[name] = row
    return {"leaves": leaves, "step0": step0,
            "port_only": sorted(set(pooled["port"]) - set(pooled["jax"]))}


def _one_ulp(params, seed=1):
    """Each value of the tree moved by one ulp up or down (zeros stay)."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        up = rng.random(x.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(x, np.float32(np.inf)),
                                    np.nextafter(x, np.float32(-np.inf)))
                           .astype(x.dtype) * (x != 0))

    return jax.tree_util.tree_map(move, params)


def trajectories(steps=50, controls=1):
    """{"jax", "jax_1ulp<c>" for c in 1..controls, "port"}: metrics per step
    from JAX's init of seed 0 (converted for the port; moved one ulp, signs
    from seed c, for the controls) on the
    cycle of make_batch(seed=i % N_BATCHES), JAX's draws from
    PRNGKey(10 + i)."""
    cfg = micro_cfg()
    jagent = JAgent(cfg)
    batches = [make_batch(seed=i) for i in range(N_BATCHES)]
    state0 = _jax_init(jagent, batches[0], 0)
    tagent = TAgent(torch_config(cfg), device="cpu")
    tagent.qfn.load_state_dict(
        convert.qfunction_state_dict(jax.device_get(state0.params)))
    states = {"jax": state0}
    for c in range(1, controls + 1):
        moved = _one_ulp(state0.params, seed=c)
        states[f"jax_1ulp{c}"] = state0._replace(
            params=moved, opt_state=jagent.opt.init(moved))
    update = jax.jit(jagent.update)
    gen = torch.Generator().manual_seed(0)
    out = {name: [] for name in states}
    out["port"] = []
    for i in range(steps):
        batch = batches[i % N_BATCHES]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.PRNGKey(10 + i)
        for name in states:
            states[name], m = update(states[name], jb, key)
            out[name].append({k: float(x) for k, x in m.items()})
        m = tagent.update(batch, gen, draws=jax_draws(cfg, key, 2))
        out["port"].append({k: float(x) for k, x in m.items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--controls", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    traj = trajectories(args.steps, args.controls)
    res = {"init": init_stats(tuple(range(args.seeds))), "trajectory": traj}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    jm = traj["jax"]
    print("step", "metric", *traj)
    for i in range(0, args.steps, max(1, args.steps // 10)):
        for k in ("bc_loss", "rgb_loss", "psnr"):
            print(i, k, *(f"{traj[n][i][k]:.6g}" for n in traj))
    others = [n for n in traj if n != "jax"]
    print("metric", f"first step with a relative gap > 1e-3 {others}",
          f"mean over the second half {list(traj)}")
    half = args.steps // 2
    for k in ("total_loss", "bc_loss", "rgb_loss", "psnr"):
        first = [next((i for i, (a, b) in enumerate(zip(jm, traj[n]))
                       if abs(b[k] - a[k]) > 1e-3 * max(1.0, abs(a[k]))),
                      None) for n in others]
        means = [float(np.mean([m[k] for m in traj[n][half:]]))
                 for n in traj]
        print(k, first, means)
    for name, row in res["init"]["leaves"].items():
        (jmu, jsd), (tmu, tsd) = row["jax"], row["port"]
        print(f"{name:60s} n={row['size']:8d} mean {jmu:+.4f}/{tmu:+.4f} "
              f"std {jsd:.4f}/{tsd:.4f}")
    for pkg in ("jax", "port"):
        print(pkg, "step0", [{k: round(m[k], 4) for k in
                              ("trans_loss", "rot_loss", "collision_loss",
                               "rgb_loss")} for m in res["init"]["step0"][pkg]])
    return res


if __name__ == "__main__":
    main()
