"""3³ stride-1 zero-SAME convolution of channels-last volumes: the wrappers of
the CUDA kernels (forward/dx and two weight-gradient schemes) and their
plain PyTorch versions.

Counterpart of `manigaussian_tpu/ops/pallas_conv.py`. The kernels
(`csrc/conv3d.cu`) replace its TPU kernels `_fwd_kernel` (through
`_conv3d_raw`) and `_dw_kernel` (through `_conv3d_dw`), and the two other
accumulation schemes of the weight gradient in
`scripts/r4_pallas_dw_repro.py` (`_dw_kernel_stacked`, `_dw_kernel_scratch`);
the bounds and the design are noted in the source.

`conv3d_same` is one autograd Function on any device. Its pieces
(`conv3d_forward`, `conv3d_dw`) launch the kernels on CUDA tensors and run
the plain versions on CPU tensors, so the types round at the same places on
both (as in the JAX custom VJP): the weights are cast to x's dtype, y comes
out float32; in the backward the cotangent is cast to x's dtype, dx (the
forward kernel on it with the taps flipped and Ci/Co swapped) is cast back to
x's dtype, and dW is cast to the weights' dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from manigaussian_tpu_torch.ops import _cuda

# The scheme `conv3d_same`'s backward uses: the faster one at the policy's
# two 100³ convolutions in bf16 (`chip_smoke.py --conv-times`; the times
# stand in PERF.md).
DW_SCHEME = "workspace"
DW_SCHEMES = ("workspace", "resident")
# Both bf16 dW schemes (csrc/conv3d.cu) walk dW tiles of one row of the
# stencil × DW_TILE_CI input × DW_TILE_CO output channels over the voxels in
# steps of VOXELS_PER_STEP; one CTA is resident on an SM at a time. The
# workspace scheme gives each (tile, slab) its CTA.
DW_TILE_CI = 64
DW_TILE_CO = 128
VOXELS_PER_STEP = 64
MAX_SLABS = 64
# what a CTA spends outside its walk (filling the pipeline, writing its
# partial tile), in steps of the walk
SLAB_OVERHEAD_STEPS = 8
# The resident scheme gives each tile one thread-block cluster of S CTAs
# (up to 8 portable, up to DW_MAX_CLUSTER with the non-portable size): the
# ranks split the tile's steps, then add the tile's DW_TILE_F4 float4 of
# partials in rank order, each rank its share.
DW_MAX_CLUSTER = 16
DW_TILE_F4 = 3 * DW_TILE_CI * DW_TILE_CO // 4


def dw_tiles(ci: int, co: int) -> int:
    """The number of dW tiles of both bf16 schemes."""
    return 9 * -(-ci // DW_TILE_CI) * -(-co // DW_TILE_CO)


def dw_steps(voxels: int) -> int:
    """The steps of one tile's walk over `voxels` voxels."""
    return -(-voxels // VOXELS_PER_STEP)


def dw_slabs(voxels: int, ci: int, co: int, sms: int) -> int:
    """Into how many slabs the workspace scheme cuts the voxels, from the
    shapes and the number of SMs alone. The grid of tiles × slabs CTAs runs
    in ⌈tiles·slabs / sms⌉ waves, each as long as one slab's walk plus the
    CTA's overhead; the slab count with the shortest run wins, the smaller
    one on a tie (a smaller workspace, a shorter sum in the second pass).
    Never more slabs than MAX_SLABS or than steps."""
    tiles = dw_tiles(ci, co)
    steps = max(1, dw_steps(voxels))
    best, best_cost = 1, None
    for slabs in range(1, min(MAX_SLABS, steps) + 1):
        waves = -(-tiles * slabs // sms)
        cost = waves * (-(-steps // slabs) + SLAB_OVERHEAD_STEPS)
        if best_cost is None or cost < best_cost:
            best, best_cost = slabs, cost
    return best


def dw_rank_steps(steps: int, cluster: int):
    """The steps [lo, hi) that each rank of a resident cluster walks, as the
    kernel computes them: ⌈steps / cluster⌉ a rank, in rank order; a rank
    that starts past the end gets none."""
    per = -(-steps // cluster)
    return [(min(steps, r * per), min(steps, r * per + per))
            for r in range(cluster)]


def dw_rank_shares(cluster: int):
    """The float4 [lo, hi) of a dW tile that each rank of a resident cluster
    adds up over the ranks and writes, as the kernel computes them."""
    share = -(-DW_TILE_F4 // cluster)
    return [(min(DW_TILE_F4, r * share), min(DW_TILE_F4, r * share + share))
            for r in range(cluster)]


def dw_resident_plan(voxels: int, ci: int, co: int, clusters: dict) -> dict:
    """The resident scheme's launch, from the shapes and `clusters` (cluster
    size S → how many clusters of S CTAs the card holds at once, from
    cudaOccupancyMaxActiveClusters): the S of the fewest waves × steps a
    CTA, where a wave is as many tiles as clusters fit at once; the smaller
    S on a tie (a shorter sum). Sizes the card cannot hold (0 clusters) and
    sizes above DW_MAX_CLUSTER are not candidates. Returns the cluster size,
    the clusters at once, the waves, the steps a CTA and the grid (tiles ×
    S CTAs)."""
    tiles, steps = dw_tiles(ci, co), max(1, dw_steps(voxels))
    best = None
    for s, held in sorted(clusters.items()):
        if not 1 <= s <= DW_MAX_CLUSTER or held < 1:
            continue
        waves = -(-tiles // held)
        per = -(-steps // s)
        if best is None or waves * per < best["waves"] * best["steps_per_cta"]:
            best = {"cluster": s, "clusters_at_once": held, "waves": waves,
                    "steps_per_cta": per, "grid": tiles * s}
    if best is None:
        raise RuntimeError(f"no cluster size of the resident dW kernel fits "
                           f"on this device: {clusters}")
    return best


def _padded(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def _taps(xp: torch.Tensor, d: int, h: int, w: int):
    """The 27 shifted views of a zero-padded [B, D+2, H+2, W+2, C] volume, in
    the order of the weights' first axis."""
    for oz in range(3):
        for oy in range(3):
            for ox in range(3):
                yield xp[:, oz:oz + d, oy:oy + h, ox:ox + w]


def conv3d_same_reference(x: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """The plain version of the forward: x [B, D, H, W, Ci], wm [27, Ci, Co]
    of x's dtype → float32 [B, D, H, W, Co]. 27 shifted matmuls of the
    operands cast to float32 (a product of two bf16 values is exact in
    float32), summed in float32."""
    _, d, h, w, _ = x.shape
    xp = _padded(x).float()
    wf = wm.to(x.dtype).float()
    y = None
    for o, tap in enumerate(_taps(xp, d, h, w)):
        t = torch.matmul(tap, wf[o])
        y = t if y is None else y + t
    return y


def conv3d_dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The plain version of the weight gradient: x [B, D, H, W, Ci], dy
    [B, D, H, W, Co] of x's dtype → float32 [27, Ci, Co]."""
    _, d, h, w, ci = x.shape
    xp = _padded(x).float()
    g = dy.to(x.dtype).float().reshape(-1, dy.shape[-1])
    return torch.stack([torch.matmul(tap.reshape(-1, ci).t(), g)
                        for tap in _taps(xp, d, h, w)])


def _library() -> ctypes.CDLL:
    lib = _cuda.load("conv3d")
    if lib.conv3d_fwd_bf16.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.conv3d_fwd_bf16, lib.conv3d_fwd_f32):
            fn.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        for fn in (lib.conv3d_dw_workspace_bf16, lib.conv3d_dw_workspace_f32):
            fn.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.conv3d_dw_resident_bf16.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
        lib.conv3d_dw_resident_f32.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        lib.conv3d_dw_resident_clusters.argtypes = [i32, ctypes.POINTER(i32)]
        for fn in (lib.conv3d_fwd_bf16, lib.conv3d_fwd_f32,
                   lib.conv3d_dw_workspace_bf16, lib.conv3d_dw_workspace_f32,
                   lib.conv3d_dw_resident_bf16, lib.conv3d_dw_resident_f32,
                   lib.conv3d_dw_resident_clusters):
            fn.restype = i32
    return lib


def _check(x: torch.Tensor, other: torch.Tensor, other_shape, other_name: str):
    """What the kernels take: contiguous, 16-byte aligned CUDA tensors of one
    dtype, float32 or bfloat16; for bfloat16, channel counts in multiples of
    8 (16-byte rows for the tile copies)."""
    if x.ndim != 5:
        raise ValueError(f"x must be [B, D, H, W, Ci], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the conv kernels take float32 or bfloat16, got {x.dtype}")
    if x.shape[:4].numel() >= 2 ** 31:
        raise ValueError(f"B·D·H·W must stay below 2^31, got {tuple(x.shape)}")
    if x.dtype == torch.bfloat16 and (x.shape[-1] % 8 or other.shape[-1] % 8):
        raise ValueError(
            "the bfloat16 conv kernels take channel counts that are multiples "
            f"of 8, got Ci={x.shape[-1]} and {other_name} {tuple(other.shape)}")
    for name, t, shape in (("x", x, tuple(x.shape)),
                           (other_name, other, tuple(other_shape))):
        if (tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{x.dtype} {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def conv3d_forward(x: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """y [B, D, H, W, Co] float32 from x [B, D, H, W, Ci] and wm [27, Ci, Co]
    of x's dtype: the forward kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return conv3d_same_reference(x, wm)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels take CUDA tensors, got {x.device}")
    b, d, h, w, ci = x.shape
    co = wm.shape[-1]
    _check(x, wm, (27, ci, co), "w")
    y = torch.empty(b, d, h, w, co, dtype=torch.float32, device=x.device)
    lib = _library()
    fn = lib.conv3d_fwd_bf16 if x.dtype == torch.bfloat16 else lib.conv3d_fwd_f32
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wm.data_ptr(), y.data_ptr(), b, d, h, w, ci, co,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"conv3d forward kernel launch failed: CUDA error {err}")
    conv3d_forward.launches += 1
    return y


_CLUSTERS = {}


def resident_clusters(device: torch.device) -> dict:
    """Cluster size S (1 .. DW_MAX_CLUSTER) → how many clusters of S resident
    dW CTAs `device` holds at once (cudaOccupancyMaxActiveClusters), asked
    once a device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CLUSTERS:
        lib = _library()
        table = {}
        with torch.cuda.device(index):
            for s in range(1, DW_MAX_CLUSTER + 1):
                held = ctypes.c_int(0)
                err = lib.conv3d_dw_resident_clusters(s, ctypes.byref(held))
                if err:
                    raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed "
                                       f"for clusters of {s}: CUDA error {err}")
                table[s] = held.value
        _CLUSTERS[index] = table
    return _CLUSTERS[index]


def conv3d_dw(x: torch.Tensor, dy: torch.Tensor,
              scheme: str = DW_SCHEME) -> torch.Tensor:
    """dW [27, Ci, Co] float32 from x [B, D, H, W, Ci] and dy [B, D, H, W, Co]
    of x's dtype, by the 'workspace' scheme (per-slab partials, then a sum in
    slab order) or the 'resident' scheme (one cluster of CTAs per dW tile,
    its partials added on chip and written once; in float32 one thread per
    dW element); the plain version on a CPU tensor. Both schemes are
    deterministic."""
    if scheme not in DW_SCHEMES:
        raise ValueError(f"scheme must be one of {DW_SCHEMES}, got {scheme!r}")
    return _dw(x, dy, scheme, None)


def conv3d_dw_resident_cluster(x: torch.Tensor, dy: torch.Tensor,
                               cluster: int) -> torch.Tensor:
    """The resident scheme in bf16 at a given cluster size (1 ..
    DW_MAX_CLUSTER) in place of `dw_resident_plan`'s: for the checks that
    need a size the plan would not pick, such as more CTAs than steps."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("a cluster size is a choice of the bf16 kernel: "
                         f"got {x.dtype} on {x.device}")
    return _dw(x, dy, "resident", cluster)


def _dw(x, dy, scheme, cluster):
    if x.device.type == "cpu":
        return conv3d_dw_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels take CUDA tensors, got {x.device}")
    b, d, h, w, ci = x.shape
    co = dy.shape[-1]
    _check(x, dy, (b, d, h, w, co), "dy")
    dw = torch.empty(27, ci, co, dtype=torch.float32, device=x.device)
    lib = _library()
    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    dims = (b, d, h, w, ci, co)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if scheme == "workspace":
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            slabs = dw_slabs(b * d * h * w, ci, co, sms)
            workspace = torch.empty(slabs, 27, ci, co, dtype=torch.float32,
                                    device=x.device)
            err = getattr(lib, f"conv3d_dw_workspace_{kind}")(
                x.data_ptr(), dy.data_ptr(), workspace.data_ptr(),
                dw.data_ptr(), *dims, slabs, stream)
        elif kind == "bf16":
            if cluster is None:
                cluster = dw_resident_plan(b * d * h * w, ci, co,
                                           resident_clusters(x.device))["cluster"]
            err = lib.conv3d_dw_resident_bf16(x.data_ptr(), dy.data_ptr(),
                                              dw.data_ptr(), *dims, cluster,
                                              stream)
        else:
            err = lib.conv3d_dw_resident_f32(x.data_ptr(), dy.data_ptr(),
                                             dw.data_ptr(), *dims, stream)
    if err:
        raise RuntimeError(f"conv3d dW kernel ({scheme}) launch failed: "
                           f"CUDA error {err}")
    _DW_ENTRY[scheme].launches += 1
    return dw


def conv3d_dw_workspace(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return conv3d_dw(x, dy, "workspace")


def conv3d_dw_resident(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return conv3d_dw(x, dy, "resident")


# launches of the CUDA kernels (the plain versions are not counted); the dW
# kernels are counted by scheme, on the entry point of each
_DW_ENTRY = {"workspace": conv3d_dw_workspace, "resident": conv3d_dw_resident}
conv3d_forward.launches = 0
conv3d_dw_workspace.launches = 0
conv3d_dw_resident.launches = 0


class _Conv3dSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ci, co = w.shape[-2:]
        return conv3d_forward(x, w.to(x.dtype).reshape(27, ci, co).contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ci, co = w.shape[-2:]
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx = conv(dy, w with the taps flipped and Ci/Co swapped)
            w_flip = w.to(x.dtype).flip(0, 1, 2).transpose(-1, -2)
            w_flip = w_flip.reshape(27, co, ci).contiguous()
            dx = conv3d_forward(g, w_flip).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # one sample at a time, each dW rounded to w's dtype and added in
            # it: the JAX wrapper stacks per-sample calls of the custom VJP
            for b in range(x.shape[0]):
                dw_b = conv3d_dw(x[b:b + 1], g[b:b + 1]).to(w.dtype)
                dw = dw_b if dw is None else dw + dw_b
            dw = dw.reshape(3, 3, 3, ci, co)
        return dx, dw


def conv3d_same_batched(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3³ stride-1 zero-SAME conv (the JAX `conv3d_same_batched`): x
    [B, D, H, W, Ci], w [3, 3, 3, Ci, Co] → float32 [B, D, H, W, Co].
    Differentiable w.r.t. x and w. The batch is part of the kernels' voxel
    axis: the forward and dx are one launch each whatever B; dW is one launch
    per sample (see the backward)."""
    if w.shape[:3] != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(f"w must be [3, 3, 3, {x.shape[-1]}, Co], got "
                         f"{tuple(w.shape)}")
    return _Conv3dSame.apply(x.contiguous(), w)


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single sample [D, H, W, Ci] → float32 [D, H, W, Co] (the JAX
    `conv3d_same`)."""
    return conv3d_same_batched(x[None], w)[0]
