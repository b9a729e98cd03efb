"""The port's train CLI with `--mesh 2` on the CPU (`--cpu`: gloo, one
process a rank), started by the CLI itself (spawn) and by the user
(`--dist HOST:PORT,NPROCS,PID`, one command per process, as
tests/test_multihost.py starts the JAX CLI): micro `w_geo` with the splat
renderer, fp32 policy, global batch 2, three steps. Its CSV's losses equal
the one-process CLI's within test_multihost.py's rtol 1e-4 / atol 1e-5
(LAMB's steps carry the first update's rounding into the later losses),
every rank reports its parameters equal to the others' bit for bit, and
rank 0 alone writes a CSV.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parallel_workers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MICRO_CLI = ["method.voxel_sizes=[20]", "method.num_latents=32",
             "method.latent_dim=32", "method.transformer_depth=1",
             "method.cross_dim_head=8", "method.latent_dim_head=8",
             "method.final_dim=16", "method.policy_dtype=float32",
             "method.neural_renderer.image_width=32",
             "method.neural_renderer.image_height=32",
             "method.neural_renderer.d_latent=16",
             "method.neural_renderer.tile_capacity=512",
             "method.neural_renderer.chunk=32",
             "rlbench.camera_resolution=[32,32]", "rlbench.demos=1",
             "rlbench.tasks=[open_drawer]", "replay.use_disk=false",
             "replay.batch_size=2", "framework.log_freq=1",
             "framework.save_freq=100", "framework.training_iterations=3"]


def _cli(args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-m", "manigaussian_tpu_torch.train", "--cpu",
         *args, *MICRO_CLI], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(procs, timeout=240):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _csv(logdir):
    with open(os.path.join(logdir, "seed0", "train_data.csv")) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("launch", ["spawn", "dist"])
def test_cli_mesh2_matches_one_process(tmp_path, launch):
    demos = str(tmp_path / "demos")
    one = str(tmp_path / "one")
    _finish([_cli(["--demo-root", demos, "--logdir", one, "--synthetic"])])
    two = str(tmp_path / "two")
    common = ["--mesh", "2", "--demo-root", demos, "--logdir", two]
    if launch == "spawn":
        outs = _finish([_cli(common)])
    else:
        port = free_port()
        outs = _finish([_cli(common + ["--dist", f"localhost:{port},2,{pid}"])
                        for pid in range(2)])
    runs = [line for out in outs for line in out.splitlines()
            if "[train] run " in line]
    assert len(runs) >= 1 and all('"params_equal_across_ranks": true' in r
                                  for r in runs)
    ref, got = _csv(one), _csv(two)
    assert len(got) == len(ref) == 3
    for k in ("total_loss", "bc_loss", "rgb_loss", "psnr"):
        np.testing.assert_allclose([float(r[k]) for r in got],
                                   [float(r[k]) for r in ref],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    csvs = [f for dp, _, fs in os.walk(two) for f in fs if f.endswith(".csv")]
    assert len(csvs) == 1
