"""A micro copy of the benchmark's data files for the CPU tests: the
published configurations cut to tiny widths (the NeRF to 32 rays of 8
coarse and 14 fine samples, the GT embedding to 3 channels), the traffic
to 32x32 frames and 5 NeRF views,
in a directory laid out as a checkout
(`<tmp>/BENCHMARK.json`, `<tmp>/benchmark/...`)."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import harness

MICRO = {"method": {"voxel_sizes": [20], "num_latents": 32, "latent_dim": 32,
                    "transformer_depth": 1, "cross_dim_head": 8,
                    "latent_dim_head": 8, "final_dim": 16,
                    "neural_renderer": {
                        "image_width": 32, "image_height": 32, "d_latent": 16,
                        "d_embed": 3,
                        "tile_capacity": 512, "max_tiles_per_gaussian": 8,
                        "chunk": 32, "mlp": {"n_blocks": 2, "d_hidden": 32},
                        "next_mlp": {"n_blocks": 2, "d_hidden": 32},
                        "n_coarse": 8, "n_fine": 6, "n_fine_depth": 2,
                        "ray_chunk_size": 32}},
         "rlbench": {"camera_resolution": [32, 32]}}
# the SD VAE's input side on the CPU (512 on the card)
FEATURE_HW = 64


def _merge(a: dict, b: dict) -> None:
    for k, v in b.items():
        if isinstance(v, dict):
            _merge(a[k], v)
        else:
            a[k] = v


def micro_base(tmp: str, policy_dtype: str = "float32") -> str:
    """The copy; returns its benchmark directory (the harness's `base`)."""
    dst = os.path.join(tmp, "benchmark")
    shutil.copytree(harness.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp)
    for name in harness.names("configs", base=dst):
        p = harness.path("configs", name, base=dst)
        with open(p) as f:
            c = json.load(f)
        _merge(c["config"], MICRO)
        c["config"]["method"]["policy_dtype"] = policy_dtype
        with open(p, "w") as f:
            json.dump(c, f)
    for name in harness.names("traffic", base=dst):
        p = harness.path("traffic", name, base=dst)
        with open(p) as f:
            m = json.load(f)
        views = m["episodes"]["nerf_views"]
        m["episodes"].update(image_size=32, nerf_size=32,
                             nerf_views=min(views, 5))
        with open(p, "w") as f:
            json.dump(m, f)
    return dst


def small_tower(monkeypatch) -> None:
    import benchmark.reference.foundation as RF
    import manigaussian_tpu_torch.models.foundation as PF
    monkeypatch.setattr(PF, "FEATURE_HW", FEATURE_HW)
    monkeypatch.setattr(RF, "FEATURE_HW", FEATURE_HW)


def context(base: str, cell: str, seed: int = 2 ** 33 + 5,
            seconds: float = 1.0, trace: bool = False):
    import torch

    from benchmark import run as R
    torch.set_num_threads(2)
    return R.Context(torch, cell, seed, seconds, trace, torch.device("cpu"),
                     base=base)
