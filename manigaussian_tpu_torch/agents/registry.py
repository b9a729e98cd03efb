"""Agent registry keyed by method name (port of
`manigaussian_tpu/agents/registry.py:26-45`).

ManiGaussian_BC, PERACT_BC and GNFACTOR_BC share the policy and so the same
`act`: PERACT_BC is the agent without the neural renderer, GNFACTOR_BC the
agent with the generalizable-NeRF renderer (`renderer_type="nerf"`) in place
of the splat world model and no dynamic field.
"""

from __future__ import annotations

import dataclasses

from manigaussian_tpu_torch.agents.bc_agent import ManiGaussianBCAgent
from manigaussian_tpu_torch.config import ManiGaussianConfig
from manigaussian_tpu_torch.utils.device import DeviceLike


def create_agent(cfg: ManiGaussianConfig, device: DeviceLike = None,
                 seed: int = 0, tile_mesh=None) -> ManiGaussianBCAgent:
    """The agent of `cfg.method.name`; `tile_mesh` shards the splat
    renderer's image tiles in training (JAX `create_agent(tile_mesh=)`)."""
    name = cfg.method.name
    if name == "ManiGaussian_BC":
        return ManiGaussianBCAgent(cfg, device=device, seed=seed,
                                   tile_mesh=tile_mesh)
    if name == "PERACT_BC":
        cfg = dataclasses.replace(
            cfg, method=dataclasses.replace(cfg.method,
                                            use_neural_rendering=False))
        return ManiGaussianBCAgent(cfg, device=device, seed=seed,
                                   tile_mesh=tile_mesh)
    if name == "GNFACTOR_BC":
        nr = dataclasses.replace(cfg.method.neural_renderer,
                                 renderer_type="nerf", use_dynamic_field=False)
        cfg = dataclasses.replace(
            cfg, method=dataclasses.replace(cfg.method,
                                            use_neural_rendering=True,
                                            neural_renderer=nr))
        return ManiGaussianBCAgent(cfg, device=device, seed=seed,
                                   tile_mesh=tile_mesh)
    raise ValueError(f"Method {name} does not exist.")
