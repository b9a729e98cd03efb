"""Configuration tree, a copy of `manigaussian_tpu/config.py`.

The PyTorch port keeps its own copy so that it imports nothing of the JAX
package; the two files hold the same dataclasses, variants and defaults
(tests/test_torch_act_eval.py holds them equal). The TPU-only knobs are
accepted as they are: `policy_unet_impl="packed"` and
`policy_conv_impl="z2d"` name the same math as the plain paths the port
runs, and `policy_attn_impl="flash"` routes the latent self-attention
through the port's CUDA kernel (ops/flash_attention.py).

Mirrors the reference Hydra config keys (`conf/config.yaml`,
`conf/method/ManiGaussian_BC.yaml`, `conf/eval.yaml`) so the four launch-variant
scripts (w_geo / w_geo_dyna / w_geo_sem / w_geo_sem_dyna,
`scripts/train_and_eval_w_geo*.sh`) port 1:1, but as typed frozen dataclasses:
jit-safe static arguments, no runtime YAML dependency (a YAML loader that fills
these dataclasses lives in utils/config_io.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLPConfig:
    """cfg.method.neural_renderer.mlp (ManiGaussian_BC.yaml:131-146)."""
    n_blocks: int = 5
    d_hidden: int = 512
    combine_layer: int = 3
    beta: float = 0.0
    use_spade: bool = False
    opacity_scale: float = 1.0
    opacity_bias: float = -2.0
    scale_bias: float = 0.02
    scale_scale: float = 0.003
    xyz_scale: float = 0.1
    xyz_bias: float = 0.0
    max_sh_degree: int = 1


@dataclass(frozen=True)
class NextMLPConfig:
    """cfg.method.neural_renderer.next_mlp (ManiGaussian_BC.yaml:148-160)."""
    d_hidden: int = 512
    n_blocks: int = 5
    combine_layer: int = 3
    warm_up: int = 3000
    use_action: bool = True


@dataclass(frozen=True)
class NeuralRendererConfig:
    """cfg.method.neural_renderer (ManiGaussian_BC.yaml:83-165)."""
    render_freq: int = 1000
    use_dynamic_field: bool = False
    lambda_nerf: float = 0.01
    lambda_embed: float = 0.01
    lambda_rgb: float = 1.0
    lambda_dyna: float = 0.01
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    zfar: float = 4.0
    znear: float = 0.1
    foundation_model_name: Optional[str] = None  # None | 'diffusion' | 'dinov2'
    # local checkpoint for the semantic tower: a torch-hub DINOv2 .pt routes
    # through the Flax ViT (models/dinov2.py); a directory through
    # transformers. None + 'dinov2'/'diffusion' -> stub with a warning.
    foundation_checkpoint: Optional[str] = None
    d_embed: int = 3
    loss_embed_fn: str = "cosine"
    # eps of the pre-blend language-feature L2-normalize. The normalize
    # backward amplifies cosine-loss gradients by up to 1/eps for near-zero
    # features; 1e-6 matches reference F.normalize semantics, but at
    # flagship scale the embed head's ignition then destabilizes the shared
    # trunk (r5 campaign: BC trans_loss 3→13). 1e-2 bounds amplification at
    # 100× and differs from exact normalize only for features with norm
    # < 0.01 (rendering/neural_renderer.py).
    feature_norm_eps: float = 1e-6
    d_latent: int = 128
    d_lang: int = 128
    image_width: int = 128
    image_height: int = 128
    coordinate_bounds: Tuple[float, ...] = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)
    mlp: MLPConfig = field(default_factory=MLPConfig)
    next_mlp: NextMLPConfig = field(default_factory=NextMLPConfig)
    # TPU rasterizer capacities (no reference analog; see ops/rasterizer.py)
    tile: int = 16
    max_tiles_per_gaussian: int = 16
    tile_capacity: int = 2048
    chunk: int = 256
    backend: str = "pallas"    # "pallas" (TPU kernel) | "xla" (lax.scan)
    # 'gaussian' = the ManiGaussian splat renderer; 'nerf' = the GNFactor
    # volumetric baseline (rendering/nerf_renderer.py, reference
    # conf/method/GNFACTOR_BC.yaml:120-148)
    renderer_type: str = "gaussian"
    n_coarse: int = 64
    n_fine: int = 32
    n_fine_depth: int = 16
    ray_chunk_size: int = 512
    depth_std: float = 0.01
    noise_std: float = 0.0
    white_bkgd: bool = False


@dataclass(frozen=True)
class MethodConfig:
    """cfg.method (ManiGaussian_BC.yaml top level)."""
    name: str = "ManiGaussian_BC"
    use_depth: bool = True
    use_neural_rendering: bool = True
    num_view_for_nerf: int = 20
    language_model: str = "CLIP"
    language_model_dim: int = 512
    # local checkpoint for the language tower: an OpenAI CLIP .pt file routes
    # through the reference-exact RN50 Flax text tower (models/clip_text.py);
    # a directory routes through transformers. None -> hashed stub provider.
    language_model_checkpoint: Optional[str] = None
    # voxelization
    image_crop_size: int = 64
    bounds_offset: Tuple[float, ...] = (0.15,)
    voxel_sizes: Tuple[int, ...] = (100,)
    # perceiver
    num_latents: int = 2048
    latent_dim: int = 512
    transformer_depth: int = 6
    transformer_iterations: int = 1
    cross_heads: int = 1
    cross_dim_head: int = 64
    latent_heads: int = 8
    latent_dim_head: int = 64
    voxel_patch_size: int = 5
    voxel_patch_stride: int = 5
    final_dim: int = 128
    # Matmul/conv compute dtype for the policy net (perceiver + 3D U-Net).
    # TPU-first deviation from the reference's fp32: params, optimizer state,
    # norms, softmaxes, losses, and the renderer stay float32; only the MXU
    # ops run bfloat16 (fp32 accumulation). 'float32' restores full fp32.
    policy_dtype: str = "bfloat16"
    # Boundary padding of the perceiver-tail 100³ convs: 'zero' (TPU-fast,
    # ~60 ms/step cheaper backward) | 'edge' (the reference's
    # padding_mode='replicate', network_utils.py:133). Differs only at the
    # outermost voxel shell of the workspace volume.
    policy_pad_mode: str = "zero"
    # Implementation of the two hot 100³ tail convs (`final`, up0 post-resize),
    # zero-pad mode only: 'xla' (nn.Conv) | 'z2d' (3 batched 2D convs) |
    # 'pallas' (ops/pallas_conv halo-tile MXU kernel). See blocks.Conv3DBlock.
    # Default 'z2d': measured on v5e (R3_SWEEP.jsonl) — 256→128 100³ conv
    # fwd+bwd 38.5 ms vs 52.9 ms for 'xla'; flagship w_geo train step
    # 4.40 steps/s vs 3.88.
    policy_conv_impl: str = "z2d"
    # voxel U-Net encoder impl: 'xla' | 'packed' (space-to-channel packing of
    # the 8/16-channel 100³/50³ stages, models/packed3d.py — same math, ~8×
    # less lane-padded HBM traffic). Default 'packed': measured on v5e
    # (R4_SWEEP.jsonl) — flagship w_geo full step 4.70 steps/s (212.6 ms) vs
    # 4.39 (227.7 ms) with 'xla'.
    policy_unet_impl: str = "packed"
    # latent self-attention impl: 'xla' | 'flash' (ops/flash_attention.py —
    # Pallas kernel keeping the [H,2048,2048] probabilities in VMEM; the XLA
    # path's fp32 prob tensor is ~26 ms/step of HBM traffic at flagship
    # shapes, R5_SWEEP.jsonl hlo_attribution). Default 'flash': measured on
    # v5e — flagship w_geo full step 6.09 steps/s (164.3 ms) vs 5.26
    # (190.2 ms) with 'xla'; standalone layer fwd+bwd 1.28 ms vs 2.51 ms
    # (R5_SWEEP.jsonl tier_step_attn / attn_micro rows).
    policy_attn_impl: str = "flash"
    # training
    input_dropout: float = 0.1
    attn_dropout: float = 0.1
    decoder_dropout: float = 0.0
    lr: float = 0.0005
    lr_scheduler: bool = False
    num_warmup_steps: int = 3000
    optimizer: str = "lamb"
    lambda_weight_l2: float = 1e-6
    # 0 = off (reference parity). Set e.g. 5.0 to clip the global grad norm —
    # batch-1 fp32 training can blow up the transformer stack (STATUS.md).
    grad_clip_norm: float = 0.0
    trans_loss_weight: float = 1.0
    rot_loss_weight: float = 1.0
    grip_loss_weight: float = 1.0
    collision_loss_weight: float = 1.0
    rotation_resolution: int = 5
    activation: str = "lrelu"
    # augmentation
    crop_augmentation: bool = True
    demo_augmentation: bool = True
    demo_augmentation_every_n: int = 10
    apply_se3: bool = True
    aug_xyz: Tuple[float, float, float] = (0.125, 0.125, 0.125)
    aug_rpy: Tuple[float, float, float] = (0.0, 0.0, 45.0)
    # ablations
    no_skip_connection: bool = False
    no_perceiver: bool = False
    no_language: bool = False
    keypoint_method: str = "heuristic"
    lambda_bc: float = 1.0
    neural_renderer: NeuralRendererConfig = field(default_factory=NeuralRendererConfig)


# The paper's 10-task RLBench suite (reference conf/config.yaml:9).
PAPER_TASKS: Tuple[str, ...] = (
    "close_jar", "open_drawer", "sweep_to_dustpan_of_size", "meat_off_grill",
    "turn_tap", "slide_block_to_color_target", "put_item_in_drawer",
    "reach_and_drag", "push_buttons", "stack_blocks")


@dataclass(frozen=True)
class RLBenchConfig:
    """cfg.rlbench (conf/config.yaml)."""
    task_name: str = "multi"
    tasks: Tuple[str, ...] = PAPER_TASKS
    demos: int = 20
    demo_path: str = ""
    # Training episode_length (reference conf/config.yaml:15); eval uses 25
    # (conf/eval.yaml:9), passed via eval.py --episode-length.
    episode_length: int = 15
    cameras: Tuple[str, ...] = ("front",)
    camera_resolution: Tuple[int, int] = (128, 128)
    scene_bounds: Tuple[float, ...] = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)
    include_lang_goal_in_obs: bool = True
    num_view_for_nerf: int = 21


@dataclass(frozen=True)
class ReplayConfig:
    batch_size: int = 1
    timesteps: int = 1
    prioritisation: bool = False
    task_uniform: bool = True
    use_disk: bool = True
    path: str = "/tmp/manigaussian_replay"
    max_parallel_processes: int = 8


@dataclass(frozen=True)
class FrameworkConfig:
    """cfg.framework (conf/config.yaml)."""
    log_freq: int = 100
    save_freq: int = 10000
    train_envs: int = 1
    replay_ratio: Optional[int] = None
    transitions_before_train: int = 200
    tensorboard_logging: bool = False
    csv_logging: bool = True
    training_iterations: int = 100010
    num_weights_to_keep: int = 60
    # Reference default False (conf/config.yaml:58): a fresh run does NOT
    # auto-resume; set True (or train.py --resume) to pick up the latest
    # checkpoint. Matches the reference's skip-already-trained guard.
    load_existing_weights: bool = False
    num_workers: int = 0
    seeds: int = 1
    start_seed: int = 0
    use_wandb: bool = False


@dataclass(frozen=True)
class TPUConfig:
    """TPU-native additions (no reference analog): mesh layout + precision."""
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    donate_state: bool = True


@dataclass(frozen=True)
class ManiGaussianConfig:
    method: MethodConfig = field(default_factory=MethodConfig)
    rlbench: RLBenchConfig = field(default_factory=RLBenchConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    framework: FrameworkConfig = field(default_factory=FrameworkConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)


def _rep(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def w_geo() -> ManiGaussianConfig:
    """Tier 1 (scripts/train_and_eval_w_geo.sh:44): GS RGB loss only."""
    c = ManiGaussianConfig()
    return _rep(c, method=_rep(c.method, neural_renderer=_rep(
        c.method.neural_renderer, render_freq=2000)))


def w_geo_dyna() -> ManiGaussianConfig:
    """Tier 2 (scripts/train_and_eval_w_geo_dyna.sh:42,61-66): + deformation
    loss; script sets lambda_dyna=0.1, lambda_embed=0.0."""
    c = ManiGaussianConfig()
    return _rep(c, method=_rep(c.method, neural_renderer=_rep(
        c.method.neural_renderer, use_dynamic_field=True,
        lambda_dyna=0.1, lambda_embed=0.0, render_freq=2000)))


def w_geo_sem() -> ManiGaussianConfig:
    """Tier 3 (scripts/train_and_eval_w_geo_sem.sh:43,61-63): + semantic
    embedding channels (foundation features)."""
    c = ManiGaussianConfig()
    return _rep(c, method=_rep(c.method, neural_renderer=_rep(
        c.method.neural_renderer, foundation_model_name="diffusion",
        render_freq=2000)))


def w_geo_sem_dyna() -> ManiGaussianConfig:
    """Tier 4 (full model, scripts/train_and_eval_w_geo_sem_dyna.sh:41-44,
    66-67): script sets lambda_dyna=0.1."""
    c = ManiGaussianConfig()
    return _rep(c, method=_rep(c.method, neural_renderer=_rep(
        c.method.neural_renderer, foundation_model_name="diffusion",
        use_dynamic_field=True, lambda_dyna=0.1, render_freq=2000)))


def micro_variant(variant: str = "w_geo", tasks=("open_drawer",),
                  iterations: int = 3000, save_freq: int = 500,
                  batch_size: int = 4, lr: float = 2e-3,
                  camera_resolution: Tuple[int, int] = (32, 32),
                  ) -> ManiGaussianConfig:
    """CI/artifact-scale downsizing of ANY launch tier: tiny dims so seeds
    train on CPU in minutes, with the tier's loss structure intact
    (use_dynamic_field / foundation_model_name / lambdas come from the
    variant, so dyna_loss and embed_loss behave exactly as at full scale).

    LAMB's layer-wise trust ratio caps every layer at ~lr relative change per
    step (utils/optimizers.py), so total optimization progress ≈ iters × lr.
    The reference budget is 100k × 5e-4 = 50; a micro run must raise lr (and
    batch size, against bs-1 gradient noise) to converge inside a CI budget —
    3000 × 2e-3 = 6 suffices at this scale (R4 learning diagnostic,
    scripts/diagnose_learning.py). The dyna warm-up gate shrinks with the
    schedule (reference next_mlp.warm_up=3000 over 100k iters → 300 here)."""
    cfg = VARIANTS[variant]()
    m = _rep(
        cfg.method, voxel_sizes=(20,), num_latents=32, latent_dim=32,
        transformer_depth=1, cross_dim_head=8, latent_dim_head=8,
        final_dim=16, policy_dtype="float32", grad_clip_norm=5.0, lr=lr,
        neural_renderer=_rep(
            cfg.method.neural_renderer, image_width=32, image_height=32,
            # capacities sized for the ray-cast scene fixtures: the table
            # plane concentrates splats per tile once scales train up
            # (64/4 overflowed mid-training; 512/8 is free at this scale)
            d_latent=16, tile_capacity=512, max_tiles_per_gaussian=8,
            chunk=32,
            mlp=_rep(cfg.method.neural_renderer.mlp,
                     n_blocks=2, d_hidden=32),
            next_mlp=_rep(cfg.method.neural_renderer.next_mlp,
                          n_blocks=2, d_hidden=32, warm_up=300)))
    return _rep(
        cfg, method=m,
        rlbench=_rep(cfg.rlbench, tasks=tuple(tasks), demos=2,
                     camera_resolution=camera_resolution, episode_length=8),
        replay=_rep(cfg.replay, use_disk=False, batch_size=batch_size),
        framework=_rep(cfg.framework, training_iterations=iterations,
                       save_freq=save_freq, log_freq=25, use_wandb=False))


def micro_w_geo(tasks=("open_drawer",), iterations: int = 3000,
                save_freq: int = 500, batch_size: int = 4,
                lr: float = 2e-3) -> ManiGaussianConfig:
    """Tier-1 micro config (see micro_variant)."""
    return micro_variant("w_geo", tasks, iterations, save_freq, batch_size,
                         lr)


VARIANTS = {
    "w_geo": w_geo,
    "w_geo_dyna": w_geo_dyna,
    "w_geo_sem": w_geo_sem,
    "w_geo_sem_dyna": w_geo_sem_dyna,
}
