"""The port's `tools/import_rlbench.py` against the JAX package's, on
tests/test_import_rlbench.py's fixture: an episode in the reference's
on-disk format (pickled rlbench Demo / Observation through fabricated module
shims, 24-bit RGB-packed depth PNGs, nerf_data).

The port's imported episode equals JAX's file for file (the same names;
arrays bit for bit, the JSON, poses and PNG files byte for byte); the depth
PNG codec writes and reads what JAX's does; the unpickler refuses a foreign
global; and the imported demos fill the port's replay and train one port
step on the CPU.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from manigaussian_tpu.tools import import_rlbench as JI
from manigaussian_tpu_torch.tools import import_rlbench as TI
from tests.test_import_rlbench import FAR, NEAR, _write_reference_episode

TASK = "open_drawer"


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    base = tmp_path_factory.mktemp("rlbench")
    src = str(base / "ref")
    _write_reference_episode(src, TASK, 0)
    _write_reference_episode(src, TASK, 1, t_steps=4)
    out = {}
    for name, mod in (("jax", JI), ("port", TI)):
        dst = str(base / name)
        assert mod.import_task(src, dst, TASK) == 2
        out[name] = dst
    return src, out["jax"], out["port"]


def test_imported_episode_equals_jax_file_for_file(imported):
    _, jax_dst, port_dst = imported
    names = _files(jax_dst)
    assert names == _files(port_dst) and len(names) > 20
    for name in names:
        a, b = os.path.join(jax_dst, name), os.path.join(port_dst, name)
        if name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif name.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files), name
            for k in x.files:
                assert x[k].dtype == y[k].dtype, (name, k)
                assert np.array_equal(x[k], y[k]), (name, k)
        else:                      # .png, .json, .txt
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_depth_png_codec_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.uniform(NEAR, FAR, (16, 16)).astype(np.float32)
    d01 = (depth - NEAR) / (FAR - NEAR)
    TI.encode_depth_png(d01).save(tmp_path / "t.png")
    JI.encode_depth_png(d01).save(tmp_path / "j.png")
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    got = TI.decode_depth_png(str(tmp_path / "t.png"), NEAR, FAR)
    assert np.array_equal(got, JI.decode_depth_png(str(tmp_path / "t.png"),
                                                   NEAR, FAR))
    np.testing.assert_allclose(got, depth, atol=1e-5)


def test_unpickler_refuses_foreign_globals(tmp_path):
    p = tmp_path / "evil.pkl"
    with open(p, "wb") as f:
        pickle.dump(os.getcwd, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        with open(p, "rb") as f:
            TI._RLBenchUnpickler(f).load()


def test_imported_demos_train_one_port_step(imported, tmp_path):
    from manigaussian_tpu_torch import config as C
    from manigaussian_tpu_torch.agents.registry import create_agent
    from manigaussian_tpu_torch.data.language import create_language_model
    from manigaussian_tpu_torch.data.pipeline import (BatchIterator,
                                                      fill_replay)
    from manigaussian_tpu_torch.data.replay import TaskUniformReplay
    _, _, port_dst = imported
    cfg = C.micro_w_geo((TASK,))
    lang = create_language_model("stub", cache_dir=str(tmp_path / "lang"))
    replay = TaskUniformReplay()
    n = fill_replay(replay, port_dst, TASK, 2, ["front"],
                    cfg.rlbench.scene_bounds, cfg.method.voxel_sizes[0],
                    cfg.method.rotation_resolution,
                    cfg.rlbench.episode_length, lang)
    assert n > 0
    it = BatchIterator(replay, 1, seed=0,
                       num_view_for_nerf=cfg.method.num_view_for_nerf)
    try:
        batch = next(it)
    finally:
        it.close()
    agent = create_agent(cfg, device="cpu")
    metrics = agent.update(batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["total_loss"]))
