"""The work counts that the roofline and MFU metrics divide by, from the
configuration's shapes (never from what the program runs), and the H100's
published peaks.

`model_flops` counts the trained model's matrix products — the policy
(3D U-Net, Perceiver IO, the 100³ convs and heads) and, in training, the
Gaussian regressor and the deformation field, or for `renderer_type`
"nerf" the NeRF's ResnetFC over the coarse and the fine pass's points — by
running this folder's plain reference of them on the meta device under
`torch.utils.flop_counter.FlopCounterMode`: 2·M·N·K a product, a
convolution as its implicit product; the backward's dX and dW products
where training. The splat renderer, the NeRF's sampling and compositing,
and the norms are not counted. `flash_bound_s` is the least time of the policy's flash
self-attention per call, from its operations, its dropout mask's integer
work and its bytes.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3 bandwidth;
# 32-bit integer operations: 64 INT32 lanes a clock on each of the 132 SMs
# (Hopper white paper) at the 1.98 GHz boost clock
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_INT32 = 132 * 64 * 1.98e9
# the attention dropout mask's integer work per score (the port's factored
# murmur3 hash: the xor of the row's and the column's mixed parts, a
# multiply, a shift and a xor, a multiply, the xor with the folded
# threshold and the compare)
DROPOUT_INT_OPS = 7


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16,
            int_ops: float = 0.0) -> float:
    """The least time: the largest of operations over the peak rate,
    integer operations over the integer rate and bytes over the memory
    rate."""
    return max(flops / peak_flops, int_ops / PEAK_INT32, nbytes / PEAK_BYTES)


def flash_bound_s(m, training: bool) -> dict:
    """Bounds of one self-attention layer's flash calls at the policy's
    shape [1, heads, latents, head_dim] bf16: the forward (with the
    dropout mask in training), and in training the backward."""
    b, h, n, d = 1, m.latent_heads, m.num_latents, m.latent_dim_head
    scores = b * h * n * n
    io = b * h * n * d * 2                     # one bf16 [B, H, N, D] tensor
    fwd_flops = 4.0 * scores * d               # q·kᵀ and p·v
    if not training:
        return {"fwd": bound_s(fwd_flops, 4 * io)}
    rate = m.attn_dropout
    words = (n + 127) // 128 * 4               # keep bits, uint32 words a row
    bits = b * h * n * words * 4
    lse = b * h * n * 4
    fwd = bound_s(fwd_flops, 4 * io + lse + bits,
                  int_ops=DROPOUT_INT_OPS * scores if rate > 0 else 0.0)
    # q·kᵀ again, dV = pᵀ·dO, dP = dO·vᵀ, dQ = dS·k, dK = dSᵀ·q
    bwd = bound_s(10.0 * scores * d, 8 * io + lse + bits)
    return {"fwd": fwd, "bwd": bwd}


def model_flops(cfg, training: bool) -> float:
    """Matrix-product FLOPs of one step (training: forward and backward)
    or one act (forward) at batch 1, counted on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.gaussian_regressor import GeneralizableGSEmbedNet
    from .reference.qfunction import perceiver_from_config, \
        renderer_from_config

    m = cfg.method
    r = m.neural_renderer
    v = m.voxel_sizes[0]
    hw = cfg.rlbench.camera_resolution
    renders = training and m.use_neural_rendering
    nerf = renders and r.renderer_type == "nerf"
    with torch.device("meta"):
        policy = perceiver_from_config(m)
        regressor = (GeneralizableGSEmbedNet(
            coordinate_bounds=tuple(r.coordinate_bounds), d_latent=r.d_latent,
            use_dynamic_field=r.use_dynamic_field,
            use_semantic_feature=r.foundation_model_name == "diffusion")
            if renders and not nerf else None)
        mlp = renderer_from_config(m).nerf.mlp if nerf else None
        grid = torch.zeros(1, v, v, v, 10)
        proprio = torch.zeros(1, 4)
        lang_emb = torch.zeros(1, m.language_model_dim * 2)
        lang_tok = torch.zeros(1, 77, m.language_model_dim)
        xyz = torch.zeros(1, hw[0] * hw[1], 3)
        action = torch.zeros(1, 8)
    counter = FlopCounterMode(display=False)
    with counter:
        trans, rot_grip, coll, d0, _ = policy(grid, proprio, lang_emb,
                                              lang_tok)
        loss = trans.sum() + rot_grip.sum() + coll.sum()
        if regressor is not None:
            params = regressor(xyz, d0, action=action)
            loss = loss + sum(t.sum() for t in _leaves(params))
        if mlp is not None:
            loss = loss + _nerf_points(mlp, d0, r).sum()
        if training:
            loss.backward()
    return float(counter.get_total_flops())


def nerf_points(r) -> int:
    """Points the NeRF's MLP runs on a step at batch 1: each of the chunk's
    rays through the coarse pass's samples, then the fine pass's sorted
    union of the coarse, importance and depth-guided samples."""
    return r.ray_chunk_size * (r.n_coarse + r.n_coarse + r.n_fine)


def _nerf_points(mlp, d0, r):
    """The ResnetFC over every point of a step: the latent taken from d0
    (so its gradient reaches the policy, as the trilinear gather's does),
    the point code beside it without one (3 + 36 + 3 channels)."""
    import torch
    p = nerf_points(r)
    latent = d0.reshape(1, -1, d0.shape[-1])[:, :1].float().expand(
        1, p, d0.shape[-1])
    code = latent.new_zeros(1, p, mlp.lin_in.weight.shape[1])
    return mlp(torch.cat([latent, code], dim=-1))


def _leaves(params):
    for val in params.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        elif val.requires_grad:
            yield val
