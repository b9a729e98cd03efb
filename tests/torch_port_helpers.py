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

