"""Demonstration-dataset generation (counterpart of
`scripts/gen_demonstrations.py`): stored episodes with multi-view
`nerf_data` folders per timestep. Backends:

  * --backend synthetic : the simulator-free generator of
    `data/synthetic.py` (the same episodes, file for file, as the JAX
    script's);
  * --backend rlbench   : drives CoppeliaSim through RLBench when installed,
    capturing the circular-path novel views like NeRFTaskRecorder
    (yarr/utils/video_utils.py:110-278).

Neither backend uses the GPU.

Usage:
    python -m manigaussian_tpu_torch.scripts.gen_demonstrations \\
        --tasks open_drawer turn_tap --save_path /data/demos \\
        --episodes_per_task 20 --backend synthetic
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--episodes_per_task", type=int, default=20)
    parser.add_argument("--backend", default="synthetic",
                        choices=["synthetic", "rlbench"])
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--nerf_views", type=int, default=21)
    parser.add_argument("--timesteps", type=int, default=40)
    args = parser.parse_args(argv)

    if args.backend == "synthetic":
        from manigaussian_tpu_torch.data.synthetic import generate_task
        for i, task in enumerate(args.tasks):
            generate_task(args.save_path, task,
                          num_episodes=args.episodes_per_task,
                          timesteps=args.timesteps,
                          h=args.image_size, w=args.image_size,
                          nerf_views=args.nerf_views,
                          nerf_hw=args.image_size, seed=i)
            print(f"[gen] {task}: {args.episodes_per_task} episodes")
    else:
        _gen_rlbench(args)


class NerfDemoRecorder:
    """Per-timestep multi-view capture on a circular camera path.

    NeRFTaskRecorder (yarr/utils/video_utils.py:110-198): at every demo
    step, move the capture camera through num_motion_steps positions and
    keep views keep_lo..keep_hi (the reference keeps 20..40 of 50 → 21
    views), saving rgb / depth / c2w pose / intrinsics per kept view.
    Decoupled from RLBench through two callables so the capture is
    testable without a simulator."""

    def __init__(self, capture_fn, step_scene_fn, num_motion_steps: int = 50,
                 keep_lo: int = 20, keep_hi: int = 40):
        # capture_fn(i) -> (rgb_u8 [H,W,3], depth_f32 [H,W], c2w [4,4],
        #                   intr [3,3]) with the camera at motion position i
        self.capture_fn = capture_fn
        self.step_scene_fn = step_scene_fn
        self.num_motion_steps = num_motion_steps
        self.keep_lo, self.keep_hi = keep_lo, keep_hi
        self.episode = {}  # t -> (rgbs, depths, extrs, intrs)
        self.t = 0

    def take_snap(self, *_args, **_kw) -> None:
        import numpy as np
        views, depths, extrs, intrs = [], [], [], []
        for i in range(self.keep_lo, min(self.keep_hi + 1,
                                         self.num_motion_steps)):
            self.step_scene_fn()
            rgb, depth, c2w, intr = self.capture_fn(i)
            views.append(rgb)
            depths.append(depth)
            extrs.append(c2w)
            intrs.append(intr)
        self.episode[self.t] = (np.stack(views), np.stack(depths),
                                np.stack(extrs), np.stack(intrs))
        self.t += 1

    def pop_episode(self):
        ep, self.episode, self.t = self.episode, {}, 0
        return ep


def _gen_rlbench(args):
    """Live demo capture through RLBench/CoppeliaSim (sim host only):
    get_demos with a per-step snapshot callback on a circular camera path,
    written in the port's episode format (data/episode.write_episode)."""
    try:
        import numpy as np
        from pyrep.objects.vision_sensor import VisionSensor
        from rlbench.action_modes.action_mode import MoveArmThenGripper
        from rlbench.action_modes.arm_action_modes import JointVelocity
        from rlbench.action_modes.gripper_action_modes import Discrete
        from rlbench.backend.utils import task_file_to_task_class
        from rlbench.environment import Environment
        from rlbench.observation_config import ObservationConfig
    except ImportError as e:
        raise SystemExit(
            "rlbench backend requires CoppeliaSim + RLBench + PyRep on this "
            "host (they are CPU x86 packages; run this script on the sim "
            "host). Use --backend synthetic for simulator-free fixtures."
        ) from e

    from manigaussian_tpu_torch.data import episode as ep_io
    from manigaussian_tpu_torch.utils.video import circular_camera_path

    size = (args.image_size, args.image_size)
    obs_config = ObservationConfig()
    obs_config.set_all(False)
    front = obs_config.front_camera
    front.rgb = front.depth = True
    front.image_size = size
    obs_config.gripper_open = True
    obs_config.gripper_pose = True
    obs_config.gripper_joint_positions = True
    obs_config.joint_velocities = True

    env = Environment(
        MoveArmThenGripper(JointVelocity(), Discrete()),
        obs_config=obs_config, headless=True)
    env.launch()
    try:
        # free-floating capture camera on the reference's circular path
        cam = VisionSensor.create(size)
        center = np.array([0.25, 0.0, 1.0])
        poses = circular_camera_path(center, radius=1.2, height=1.4,
                                     n_views=args.timesteps or 50)

        def capture(i):
            cam.set_matrix(poses[i % len(poses)])
            rgb = (cam.capture_rgb() * 255.0).astype(np.uint8)
            depth = cam.capture_depth(in_meters=False).astype(np.float32)
            return rgb, depth, cam.get_matrix(), cam.get_intrinsic_matrix()

        for task_name in args.tasks:
            task_env = env.get_task(task_file_to_task_class(task_name))
            for e in range(args.episodes_per_task):
                rec = NerfDemoRecorder(capture, env._pyrep.step,
                                       num_motion_steps=len(poses),
                                       keep_lo=20,
                                       keep_hi=20 + args.nerf_views - 1)
                demo, = task_env.get_demos(
                    1, live_demos=True, callable_each_step=rec.take_snap)
                descs, _ = task_env.reset()
                obs_list = list(demo)
                t = len(obs_list)
                ep_io.write_episode(
                    args.save_path, task_name, e,
                    rgb={"front": np.stack([o.front_rgb for o in obs_list])},
                    depth={"front": np.stack(
                        [o.front_depth for o in obs_list])},
                    low_dim=dict(
                        gripper_open=np.array(
                            [o.gripper_open for o in obs_list], np.float32),
                        gripper_pose=np.stack(
                            [o.gripper_pose for o in obs_list]),
                        gripper_joint_positions=np.stack(
                            [o.gripper_joint_positions for o in obs_list]),
                        joint_velocities=np.stack(
                            [o.joint_velocities for o in obs_list]),
                        ignore_collisions=np.zeros(t, np.float32)),
                    camera_extrinsics={"front": np.stack(
                        [o.misc["front_camera_extrinsics"]
                         for o in obs_list])},
                    camera_intrinsics={"front": np.stack(
                        [o.misc["front_camera_intrinsics"]
                         for o in obs_list])},
                    descriptions=list(descs),
                    nerf_views=rec.pop_episode())
                print(f"[gen] {task_name} episode {e}: {t} steps, "
                      f"{args.nerf_views} nerf views/step")
    finally:
        env.shutdown()


if __name__ == "__main__":
    main()
