"""The port's host-side copies and small ops against the JAX package: the
config tree, synthetic demos, keypoints, the language stub, depth
unprojection and the rotation codec."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu import config as JC
from manigaussian_tpu.data import episode as jep
from manigaussian_tpu.data.keypoints import keypoint_discovery as j_kp
from manigaussian_tpu.data.language import HashedStubLanguageModel as JStub
from manigaussian_tpu.data.synthetic import generate_task as j_generate
from manigaussian_tpu.ops.camera import depth_to_pointcloud as j_unproject
from manigaussian_tpu.ops import rotation as JR
from manigaussian_tpu_torch import config as TC
from manigaussian_tpu_torch.data import episode as tep
from manigaussian_tpu_torch.data.keypoints import keypoint_discovery as t_kp
from manigaussian_tpu_torch.data.language import (CachedLanguageModel,
                                                  HashedStubLanguageModel,
                                                  create_language_model)
from manigaussian_tpu_torch.data.synthetic import generate_task as t_generate
from manigaussian_tpu_torch.ops import rotation as TR
from manigaussian_tpu_torch.ops.camera import depth_to_pointcloud
from manigaussian_tpu_torch.utils.config_io import (from_dict,
                                                    load_saved_config,
                                                    save_config)
from tests.torch_port_helpers import assert_close


@pytest.mark.parametrize("variant", sorted(JC.VARIANTS))
def test_config_copy_is_identical(variant, tmp_path):
    assert dataclasses.asdict(TC.VARIANTS[variant]()) == \
        dataclasses.asdict(JC.VARIANTS[variant]())
    assert dataclasses.asdict(TC.micro_variant(variant)) == \
        dataclasses.asdict(JC.micro_variant(variant))
    # a config saved by either package reloads in the port
    cfg = from_dict({"method": {"lr": "0.001", "voxel_sizes": "[20]"}},
                    TC.VARIANTS[variant]())
    save_config(cfg, str(tmp_path))
    assert load_saved_config(str(tmp_path)) == cfg


def test_synthetic_demos_are_identical(tmp_path):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    kw = dict(num_episodes=1, timesteps=8, h=16, w=16, nerf_views=2,
              nerf_hw=8, seed=3)
    j_generate(jroot, "task", **kw)
    t_generate(troot, "task", **kw)
    (jpath,), (tpath,) = jep.list_episodes(jroot, "task"), \
        tep.list_episodes(troot, "task")
    jd, td = jep.load_episode(jpath), tep.load_episode(tpath)
    for f in ("gripper_open", "gripper_pose", "joint_velocities"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    for t in range(8):
        np.testing.assert_array_equal(tep.load_image(td.rgb_paths["front"][t]),
                                      jep.load_image(jd.rgb_paths["front"][t]))
        np.testing.assert_array_equal(tep.load_depth(td.depth_paths["front"][t]),
                                      jep.load_depth(jd.depth_paths["front"][t]))
    assert t_kp(td.gripper_open, td.joint_velocities) == \
        j_kp(jd.gripper_open, jd.joint_velocities)
    with open(os.path.join(tpath, tep.DESCRIPTIONS)) as f:
        assert json.load(f) == jd.descriptions


def test_language_stub_is_identical(tmp_path):
    text = "open the top drawer"
    for a, b in zip(HashedStubLanguageModel().encode(text), JStub().encode(text)):
        np.testing.assert_array_equal(a, b)
    cached = create_language_model("CLIP", cache_dir=str(tmp_path))
    assert isinstance(cached, CachedLanguageModel)
    np.testing.assert_array_equal(cached.encode(text)[1],
                                  JStub().encode(text)[1])
    # a checkpoint is never passed over for the stub: a directory goes to
    # the transformers provider, which finds no tokenizer in an empty one
    with pytest.raises((OSError, TypeError, ValueError)):
        create_language_model("CLIP", checkpoint_dir=str(tmp_path))


def test_depth_to_pointcloud_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 3.0, (12, 16)).astype(np.float32)
    a = rng.standard_normal(3)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)) + np.eye(3))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = rot, a
    intr = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
    ref = j_unproject(jnp.asarray(depth), jnp.asarray(w2c), jnp.asarray(intr))
    out = depth_to_pointcloud(*map(torch.from_numpy, (depth, w2c, intr)))
    assert_close(out, ref, 1e-6)


def test_rotation_codec_matches_jax():
    rng = np.random.default_rng(1)
    disc = rng.integers(0, 72, (64, 3)).astype(np.int32)
    ref_q = JR.discrete_euler_to_quaternion(jnp.asarray(disc), 5.0)
    q = TR.discrete_euler_to_quaternion(torch.from_numpy(disc), 5.0)
    assert_close(q, ref_q, 1e-6)
    quats = rng.standard_normal((64, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        TR.quaternion_to_discrete_euler(torch.from_numpy(quats), 5.0).numpy(),
        np.asarray(JR.quaternion_to_discrete_euler(jnp.asarray(quats), 5.0)))
