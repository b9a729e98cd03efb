"""ManiGaussian behavior-cloning agent: the train step `update` and the
greedy policy `act`.

Port of `manigaussian_tpu/agents/bc_agent.py`: the optimizer construction
(:52-72), `normalize_rgb` (:75-77), `update` (:126-206), `act` (:209-233)
and `render_for_vis` (:236-254), i.e. reference qattention:654-1010 and
1063-1158 plus the stack agent's continuous-action assembly. The JAX agent
is functional (params and optimizer state are passed in and returned);
here the agent owns its QFunction module, its optimizer state and its step
count. Weights come from a seed (`torch.Generator`), a checkpoint, or
`convert.py`.

Multi-device: `update(..., mesh=)` runs one rank's share of a sharded step
(with a "data" axis, its rows of the global batch;
`parallel/train_sharded.py`): every draw is made for the global batch, the
gradients are averaged over the mesh's ranks before the optimizer and the
metrics reduced over the data group. `tile_mesh` (JAX
`ManiGaussianBCAgent(tile_mesh=)`) shards the splat renderer's tiles in
`update`; `act` and `render_for_vis` render without it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from manigaussian_tpu_torch.agents.qfunction import (QFunction, QOutput,
                                                     choose_highest_action)
from manigaussian_tpu_torch.config import ManiGaussianConfig
from manigaussian_tpu_torch.models.blocks import initialize
from manigaussian_tpu_torch.ops import losses as L
from manigaussian_tpu_torch.ops.augmentation import (SE3Draws,
                                                     apply_se3_augmentation,
                                                     sample_se3_draws)
from manigaussian_tpu_torch.ops.rotation import discrete_euler_to_quaternion
from manigaussian_tpu_torch.parallel.train_sharded import (average_gradients,
                                                           reduce_metrics)
from manigaussian_tpu_torch.rendering.neural_renderer import RenderResult
from manigaussian_tpu_torch.utils.device import (DeviceLike, constant,
                                                 resolve_device)
from manigaussian_tpu_torch.utils.optimizers import (AdamW, Lamb,
                                                     warmup_cosine_schedule)
from manigaussian_tpu_torch.utils.profiling import trace_annotation


class ActResult(NamedTuple):
    continuous_action: torch.Tensor   # [B, 9]: xyz(3) quat_xyzw(4) grip(1) collision(1)
    trans_coords: torch.Tensor        # [B, 3] int32 voxel index
    rot_grip_indices: torch.Tensor    # [B, 4] int32
    collision_indices: torch.Tensor   # [B, 1] int32


def normalize_rgb(rgb_01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB → [-1,1] (helpers/preprocess_agent.py:25-26)."""
    return rgb_01 * 2.0 - 1.0


OBS_KEYS = ("rgb", "pcd", "low_dim_state", "lang_goal_emb", "lang_token_embs")
NERF_KEYS = ("nerf_target_rgb", "nerf_target_pose", "nerf_target_intrinsic",
             "nerf_next_target_rgb", "nerf_next_target_pose",
             "nerf_next_target_intrinsic", "gt_embed", "action")


def make_optimizer(cfg: ManiGaussianConfig, params):
    """`method.optimizer`: "lamb" the reference LAMB, "adam" optax's AdamW,
    each with weight decay `lambda_weight_l2`, the warmup-cosine schedule
    when `lr_scheduler` is set and the global-norm clip when
    `grad_clip_norm` > 0 (JAX bc_agent.py:52-72)."""
    m = cfg.method
    lr = m.lr
    if m.lr_scheduler:
        lr = warmup_cosine_schedule(m.lr, m.num_warmup_steps,
                                    cfg.framework.training_iterations)
    if m.optimizer == "lamb":
        opt = Lamb
    elif m.optimizer == "adam":
        opt = AdamW
    else:
        raise ValueError(f"unknown optimizer {m.optimizer}")
    return opt(params, lr, weight_decay=m.lambda_weight_l2,
               grad_clip_norm=m.grad_clip_norm)


class ManiGaussianBCAgent:
    """Holds the config, the device, the QFunction (in eval mode outside
    `update`), the optimizer, the step count and, on CUDA, the act's
    captured graphs."""

    def __init__(self, cfg: ManiGaussianConfig, device: DeviceLike = None,
                 seed: int = 0, tile_mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tile_mesh = tile_mesh
        # weights are drawn on the CPU so one seed gives one net on any device
        self.qfn = initialize(QFunction(cfg.method),
                              torch.Generator().manual_seed(seed))
        self.qfn.to(self.device).eval()
        self.bounds = torch.tensor(cfg.rlbench.scene_bounds,
                                   dtype=torch.float32, device=self.device)
        self.opt: Optional[Union[Lamb, AdamW]] = None
        self.step = 0
        self.act_graph_counts = {"captures": 0, "replays": 0, "eager": 0}
        self._act_graphs: Dict[tuple, _ActGraph] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None

    def optimizer(self) -> Union[Lamb, AdamW]:
        """The optimizer state, made at the first use (act needs none)."""
        if self.opt is None:
            self.opt = make_optimizer(self.cfg, self.qfn.parameters())
        return self.opt

    def update(self, batch: Dict, generator: torch.Generator,
               draws: Optional[SE3Draws] = None,
               mesh=None) -> Dict[str, torch.Tensor]:
        """One BC step (JAX `update`): normalize; the augmentation draws
        (from `generator`, or `draws` as given) and their application; the
        forward in train mode (dropout from `generator`); the loss dict with
        the JAX metric names; backward; the clip and the optimizer step. `batch` holds
        numpy arrays or tensors (the schema of data/pipeline.assemble_batch).
        With `mesh`, `batch` is this rank's rows of the global batch and
        `draws` (when given) the global batch's; the gradients are averaged
        over the mesh's ranks and the metrics reduced over its data group.
        Returns the metrics as 0-d tensors on the device (no host sync).
        The three stages are named ranges for torch.profiler
        ("update/forward", "update/backward", "update/optimizer")."""
        m = self.cfg.method
        dev = self.device
        b = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                device=dev)
             for k, v in batch.items() if k in OBS_KEYS + NERF_KEYS + (
                 "trans_action_indicies", "rot_grip_action_indicies",
                 "ignore_collisions", "gripper_pose")}
        rgb = normalize_rgb(b["rgb"].float())
        pcd = b["pcd"].float()
        action_trans = b["trans_action_indicies"][:, :3]
        action_rot_grip = b["rot_grip_action_indicies"]
        if m.apply_se3:
            nb = pcd.shape[0]
            rows = None if mesh is None else mesh.rows(nb)
            if draws is None:
                draws = sample_se3_draws(generator, rows.total if rows else nb,
                                         m.aug_rpy, m.rotation_resolution)
            if rows is not None:   # [K, B, 3]: the rank's rows of the batch
                draws = SE3Draws(*(d.narrow(1, rows.lo, nb) for d in draws))
            out = apply_se3_augmentation(
                draws, pcd, b["gripper_pose"].float(), action_trans,
                action_rot_grip, self.bounds, trans_aug_range=m.aug_xyz,
                rot_aug_resolution=m.rotation_resolution,
                voxel_size=m.voxel_sizes[0],
                rot_resolution=m.rotation_resolution)
            action_trans, action_rot_grip, pcd = (out.action_trans,
                                                  out.action_rot_grip, out.pcd)
        opt = self.optimizer()
        with trace_annotation("update/forward"):
            self.qfn.train()
            total, metrics = self._losses(b, rgb, pcd, action_trans,
                                          action_rot_grip, generator, mesh)
            self.qfn.eval()
        opt.zero_grad()
        with trace_annotation("update/backward"):
            total.backward()
            if mesh is not None:
                average_gradients(opt.params, mesh)
        with trace_annotation("update/optimizer"):
            opt.step()
        self.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics if mesh is None else reduce_metrics(metrics, mesh)

    def _losses(self, b, rgb, pcd, action_trans, action_rot_grip, generator,
                mesh=None):
        """The train-mode forward and the loss dict (JAX `loss_fn`)."""
        m = self.cfg.method
        nrot = int(360 // m.rotation_resolution)
        v = m.voxel_sizes[0]
        nerf = {k: (b[k].float() if k in b else None) for k in NERF_KEYS}
        q = self.qfn(rgb, pcd, b["low_dim_state"].float(),
                     b["lang_goal_emb"].float(), b["lang_token_embs"].float(),
                     self.bounds, use_neural_rendering=m.use_neural_rendering,
                     step=self.step, deterministic=False, generator=generator,
                     mesh=mesh, tile_mesh=self.tile_mesh, **nerf)
        bs = q.q_trans.shape[0]
        at = action_trans.long()
        trans_idx = (at[:, 0] * v + at[:, 1]) * v + at[:, 2]
        trans_loss = L.softmax_cross_entropy_with_index(
            q.q_trans.reshape(bs, -1), trans_idx)
        q_rot = q.q_rot_grip[:, :nrot * 3].reshape(bs, 3, nrot)
        rot_loss = sum(L.softmax_cross_entropy_with_index(
            q_rot[:, i], action_rot_grip[:, i]) for i in range(3))
        grip_loss = L.softmax_cross_entropy_with_index(
            q.q_rot_grip[:, nrot * 3:], action_rot_grip[:, 3])
        coll_loss = L.softmax_cross_entropy_with_index(
            q.q_collision, b["ignore_collisions"][:, 0])
        combined = (trans_loss * m.trans_loss_weight
                    + rot_loss * m.rot_loss_weight
                    + grip_loss * m.grip_loss_weight
                    + coll_loss * m.collision_loss_weight)
        total = m.lambda_bc * combined
        metrics = {"trans_loss": trans_loss, "rot_loss": rot_loss,
                   "grip_loss": grip_loss, "collision_loss": coll_loss,
                   "bc_loss": combined}
        r = q.render_losses
        if r is not None:
            total = total + m.neural_renderer.lambda_nerf * r.loss
            metrics.update(rgb_loss=r.loss_rgb, embed_loss=r.loss_embed,
                           dyna_loss=r.loss_dyna, psnr=r.psnr,
                           overflow_splats=r.overflow_splats,
                           overflow_gaussians=r.overflow_gaussians)
        metrics["total_loss"] = total
        return total, metrics

    @torch.no_grad()
    def q_values(self, observation: Dict) -> QOutput:
        """The QFunction's outputs for one batched observation (act's first
        half, exposed for parity checks)."""
        with trace_annotation("policy/inputs"):
            o = {k: torch.as_tensor(observation[k], dtype=torch.float32,
                                    device=self.device) for k in OBS_KEYS}
            rgb = normalize_rgb(o["rgb"])
        return self._q(rgb, o)

    def _q(self, rgb: torch.Tensor, o: Dict[str, torch.Tensor]) -> QOutput:
        return self.qfn(rgb, o["pcd"], o["low_dim_state"], o["lang_goal_emb"],
                        o["lang_token_embs"], self.bounds)

    @torch.no_grad()
    def render_for_vis(self, batch: Dict) -> Optional[RenderResult]:
        """The inference-mode novel-view render of the recon panels
        (QFunction.render, qattention:289-359): the batch's first target
        view, with no target image, at step 0, deterministic. Returns the
        RenderResult (the NeRF renderer: the full image of sample 0)."""
        keys = OBS_KEYS + ("nerf_target_pose", "nerf_target_intrinsic",
                           "nerf_next_target_pose",
                           "nerf_next_target_intrinsic", "action")
        b = {k: torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(
            batch[k]) else batch[k], device=self.device).float()
             for k in keys if k in batch}
        q = self.qfn(normalize_rgb(b["rgb"]), b["pcd"], b["low_dim_state"],
                     b["lang_goal_emb"], b["lang_token_embs"], self.bounds,
                     use_neural_rendering=True,
                     nerf_target_pose=b.get("nerf_target_pose"),
                     nerf_target_intrinsic=b.get("nerf_target_intrinsic"),
                     nerf_next_target_pose=b.get("nerf_next_target_pose"),
                     nerf_next_target_intrinsic=b.get(
                         "nerf_next_target_intrinsic"),
                     action=b.get("action"), step=0, deterministic=True)
        return q.render_result

    @torch.no_grad()
    def act(self, observation: Dict) -> ActResult:
        """Greedy policy. observation: rgb [B,ncam,H,W,3] in [0,1], pcd,
        low_dim_state, lang_goal_emb, lang_token_embs (numpy or tensors).
        The stages are named ranges for torch.profiler, in call order:
        "policy/inputs", "policy/voxelize" (QFunction), "policy/encoder",
        "policy/perceiver", "policy/decoder" (the Perceiver) and
        "policy/decode".

        On CUDA everything after the inputs' upload is one CUDA graph per
        observation signature (`_ActGraph`): the first act of a signature
        captures it, every later one uploads into its static inputs and
        replays it under "policy/graph", where the stage ranges do not
        show. The returned tensors are the act's own, which later acts do
        not overwrite. `act_graph_counts` counts each act once, as a
        capture, a replay or an eager act (the CPU)."""
        if self.device.type != "cuda":
            self.act_graph_counts["eager"] += 1
            return self._act_eager(observation)
        shapes = {k: _shape(observation[k]) for k in OBS_KEYS}
        key = (self.device, self.cfg.method.policy_dtype, self.qfn.training,
               tuple(shapes.items()))
        g = self._act_graphs.get(key)
        if g is None or not g.holds(self.qfn, self.bounds):
            g = self._act_graphs[key] = self._capture(observation, shapes)
            self.act_graph_counts["captures"] += 1
        else:
            with trace_annotation("policy/inputs"):
                g.upload(observation)
            self.act_graph_counts["replays"] += 1
        with trace_annotation("policy/graph"):
            g.graph.replay()
            return ActResult(*(t.clone() for t in g.outputs))

    def _act_eager(self, observation: Dict) -> ActResult:
        return self._decode(self.q_values(observation))

    def _act_from(self, o: Dict[str, torch.Tensor]) -> ActResult:
        """The act from its float32 inputs on the device: what a graph
        holds."""
        return self._decode(self._q(normalize_rgb(o["rgb"]), o))

    def _capture(self, observation: Dict,
                 shapes: Dict[str, Tuple[int, ...]]) -> "_ActGraph":
        """Upload, one eager act on a side stream (cuDNN's choice, the
        caching allocator, `constant`), then the capture on that stream,
        into a private memory pool. Nothing here waits for the device. The
        capture is "relaxed": the port's kernels bind the device's context
        with `cudaFree(nullptr)` before they encode a tensor map, a call
        that a stricter capture refuses."""
        g = _ActGraph(shapes, self.device, self.qfn, self.bounds)
        with trace_annotation("policy/inputs"):
            g.upload(observation)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        side, main = self._capture_stream, torch.cuda.current_stream(
            self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._act_from(g.inputs)
            g.graph.capture_begin(capture_error_mode="relaxed")
            try:
                g.outputs = self._act_from(g.inputs)
            finally:
                g.graph.capture_end()
        main.wait_stream(side)
        return g

    def _decode(self, q: QOutput) -> ActResult:
        m = self.cfg.method
        with trace_annotation("policy/decode"):
            with trace_annotation("policy/decode/argmax"):
                coords, rot_grip, coll = choose_highest_action(
                    q.q_trans, q.q_rot_grip, q.q_collision,
                    m.rotation_resolution)
            with trace_annotation("policy/decode/quaternion"):
                quat = discrete_euler_to_quaternion(
                    rot_grip[:, :3], float(m.rotation_resolution))
            with trace_annotation("policy/decode/action"):
                bounds = self.bounds
                vsize = constant(float(m.voxel_sizes[0]), torch.float32,
                                 self.device)
                res = (bounds[3:] - bounds[:3]) / vsize
                # attention coordinate = voxel center (qattention:1120-1123)
                attention_coord = (bounds[:3] + res * coords.to(torch.float32)
                                   + res / 2)
                continuous = torch.cat(
                    [attention_coord, quat, rot_grip[:, 3:4].to(torch.float32),
                     coll.to(torch.float32)], dim=-1)
        return ActResult(continuous, coords, rot_grip, coll)


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


class _ActGraph:
    """One act captured as a CUDA graph: the float32 device inputs it reads,
    the pinned host buffers they are uploaded from, the outputs it writes
    (`outputs`, an ActResult) and where the parameters, buffers and bounds
    it reads lived when it was captured."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]],
                 device: torch.device, qfn: torch.nn.Module,
                 bounds: torch.Tensor):
        self.inputs = {k: torch.empty(s, dtype=torch.float32, device=device)
                       for k, s in shapes.items()}
        self.staging = {k: torch.empty(s, dtype=torch.float32,
                                       pin_memory=True)
                        for k, s in shapes.items()}
        self.staging_np = {k: t.numpy() for k, t in self.staging.items()}
        self.uploaded = torch.cuda.Event()
        self.modules = tuple(qfn.modules())
        self.addresses = self._addresses(bounds)
        self.graph = torch.cuda.CUDAGraph()
        self.outputs: Optional[ActResult] = None

    def _addresses(self, bounds: torch.Tensor) -> Tuple[int, ...]:
        # the modules' own dicts: a walk of `parameters()` costs ~5 x more
        return tuple(t.data_ptr() for m in self.modules
                     for d in (m._parameters, m._buffers)
                     for t in d.values() if t is not None) + (
                         bounds.data_ptr(),)

    def holds(self, qfn: torch.nn.Module, bounds: torch.Tensor) -> bool:
        """Whether the graph still reads this module's tensors: an in-place
        update (`load_state_dict`, the optimizer) keeps their addresses; a
        rebound parameter or buffer, or a move, does not."""
        return (self.modules[0] is qfn
                and self._addresses(bounds) == self.addresses)

    def upload(self, observation: Dict) -> None:
        """Each input into its static buffer, converted to float32 as
        `q_values` converts it: from the host through its pinned buffer
        with a `non_blocking` copy, from the device by a copy on the device.
        The pinned buffers are written only once the previous upload has
        read them (in an act loop the caller's read of the action has long
        since waited for that), and by numpy: torch's copy of a 128² frame
        splits across intra-op threads, whose wake-ups on a loaded host
        cost milliseconds."""
        self.uploaded.synchronize()
        for k, dst in self.inputs.items():
            src = observation[k]
            if torch.is_tensor(src) and src.device.type == "cuda":
                dst.copy_(src, non_blocking=True)
                continue
            if torch.is_tensor(src):
                self.staging[k].copy_(src)
            else:
                np.copyto(self.staging_np[k], src, casting="unsafe")
            dst.copy_(self.staging[k], non_blocking=True)
        self.uploaded.record()
