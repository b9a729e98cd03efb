"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Parity inputs are made with numpy from a seed and handed to both packages.
JAX parameters are not drawn with flax's initializers (an eager flax init of
the policy takes most of a minute on the CPU): the tree's shapes come from
`jax.eval_shape` of the module's init, and the values from numpy — kernels
scaled by 1/sqrt(fan_in), and nonzero norm scales and biases, so a bias or
scale mapped to the wrong place shows.
"""

import dataclasses

import jax
import numpy as np
import torch

# Tier-1 runs several test files at once (pytest-xdist), each worker a
# process. torch's OpenMP pool defaults to one thread a core in every
# worker, and its spinning threads then oversubscribe the cores: six micro
# train CLI runs at once took 317 s each on an 8-core host, against 13 s
# on two threads and 11 s on one. On two threads, the first fp32
# attention of a fresh process under that load came out 3e-5 off (11 of
# 96 runs; the same call again was right), on one thread never (0 of 36);
# that difference is not explained (ROADMAP C). Every worker imports this
# module when it collects the tests, so the port's tests (and the torch
# twins of the JAX tests in the same worker) run torch on one thread,
# whatever the host's core count or OMP_NUM_THREADS.
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)


def load_jax_train_state(agent, state) -> None:
    """Put the port's `agent` at JAX's `TrainState`, leaf for leaf: the
    parameters, the optimizer's moments (LAMB's or AdamW's mu and nu) and
    count, and the step count. A port step run from JAX's state before
    JAX's step is held to one step's rounding: two trajectories part by
    more, since LAMB turns a gradient's last bits into moves of either
    sign."""
    from manigaussian_tpu_torch import convert
    host = jax.device_get(state)
    agent.qfn.load_state_dict(convert.qfunction_state_dict(host.params))
    names = [n for n, _ in agent.qfn.named_parameters()]
    moments = _moments(host.opt_state)
    opt = agent.optimizer()
    step = int(host.step)
    opt.load_state_dict({"kind": opt.kind, "count": step, **{
        k: [convert.qfunction_state_dict(moments[k])[n] for n in names]
        for k in ("mu", "nu")}})
    agent.step = step


def _moments(opt_state):
    """{"mu", "nu"} of the state inside an optax chain (LambState,
    ScaleByAdamState, under inject_hyperparams or not)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return {"mu": opt_state.mu, "nu": opt_state.nu}
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _moments(part)
        if found is not None:
            return found
    return None


def random_flax_params(module, *args, seed: int = 0, **kwargs):
    """{"params": ...} for `module` with numpy-drawn values."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def torch_config(jax_cfg):
    """The JAX package's config → the port's (same fields, same values)."""
    from manigaussian_tpu_torch.config import ManiGaussianConfig
    from manigaussian_tpu_torch.utils.config_io import from_dict
    return from_dict(dataclasses.asdict(jax_cfg), ManiGaussianConfig())


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(actual, expected, tol, err_msg=""):
    np.testing.assert_allclose(to_np(actual), to_np(expected), atol=tol,
                               rtol=tol, err_msg=err_msg)


def jax_script(name: str):
    """The JAX package's user script `scripts/<name>.py`, loaded as a module
    of its own name (each puts the repository root on sys.path itself)."""
    import importlib.util
    import os
    import sys
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod

