"""The numbers that decide `correct`, each worked out from the program's
outputs and the plain reference's (`reference/`).

Training (`training_numbers`): the reference follows the program's first
three steps from the same seed, batches and draws, once in float32 and
once, as the witness, with the policy's products in the precision the
configuration states (bfloat16). A leaf's gap is the gap between two norms
of that leaf, relative to the float32 reference's norm of that leaf or of
the median leaf, whichever is larger; leaves whose float32 gradient is
under a thousandth of the median leaf's (nought to rounding, e.g. a bias
under softmax) are left out. The numbers a cell's limits may hold:
  attn    the first step's self-attention blocks (the flash kernel with
          its to_out projection): the widest relative L2 gap of a block's
          output, over the witness's or `ATTN_FLOOR`, whichever is larger
  attn_bwd  the first step's flash backward: each call's dq, dk and dv
          as the program's backward returned them, against the exact
          float64 gradient of the same operands, upstream gradient and
          keep mask (`flash_backward_gap`): the widest tile's gap
  lamb_step  the first step's LAMB update: each leaf's change p1 − p0
          against the reference's LAMB applied in float64 to p0 and the
          gradient the program's optimizer got (m / (1 − β1)); the widest
          leaf's relative L2 gap (`lamb_step_gaps`)
  change  the median leaf's gap of the parameters' change over the three
          steps
  nerf_rays  GNFactor's NeRF at the first step: the coarse and the fine
          pass's colour and embedding of every ray of the chunk, the
          widest relative L2 gap, over the witness's or `RAYS_FLOOR`,
          whichever is larger
  render  the first step's widest relative gap of the render losses
          (`rgb_loss`; the semantic tiers' `embed_loss`; the dynamic tiers'
          `dyna_loss`, the next frame's render; GNFactor's NeRF: `rgb_loss`
          and `embed_loss`, each its coarse and fine pass's; both sides
          start from the same weights), over the witness's or
          `RENDER_FLOOR`, whichever is larger
  gt_embed  the semantic tiers' GT embedding, which the program works out
          in its prefetch thread and the reference again from the same
          views: the worst followed step's gap after aligning the channels
          (`aligned_gap`)
  grad    the median leaf's gap of the first step's gradient (the
          program's read from LAMB's first moment after one step,
          m / (1 − β1)), in units of the witness's median-leaf gap
Printed beside them (PERF.md gives why those a cell does not compare are
not): each step's loss gap (`loss`, `loss_step1`, `<head>_loss`), the
worst leaf's gaps (`grad_worst_leaf`, `change_worst_leaf`), the median
leaf's gradient gap itself (`grad_median`) and the witness's
(`grad_median_bf16`), the attention, ray, render and renderer gaps
themselves (`attn_gap`, `nerf_rays_gap`, `render_gap`,
`grad_renderer_gap` and the witness's `_bf16`), the GT embedding's gap
without alignment (`gt_embed_plain`), and `grad_renderer`: the median gap
of the renderer's leaves' first gradient (the Gaussian regressor and the
deformation field, or the NeRF's MLP, against their own median leaf) over
the witness's or `RENDERER_FLOOR`, whichever is larger.

Act (`action_gap`): for every act of the window the reference's Q-values
on the same observation;
  action  the widest gap by which a chosen index's reference logit lies
          below that head's best, in units of the head's spread (the
          standard deviation of the reference's translation logits; of the
          rotation, gripper and collision logits together for the others)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

LOSS_HEADS = ("trans_loss", "rot_loss", "grip_loss", "collision_loss",
              "rgb_loss", "embed_loss", "dyna_loss")
RENDER_HEADS = ("rgb_loss", "embed_loss", "dyna_loss")
# the leaves of the Gaussian regressor and the deformation field, or of
# GNFactor's NeRF
RENDERER_PREFIX = "neural_renderer."
# gaps under these are rounding: the witness's gap is not read below them
# (where the render hardly depends on the policy's precision both sides'
# gaps are rounding, and their ratio is noise)
RENDERER_FLOOR = 1e-3       # a gap of leaf norms
RENDER_FLOOR = 5e-3         # a relative gap of a render loss
ATTN_FLOOR = 1e-4           # a relative gap of attention outputs
RAYS_FLOOR = 1e-4           # a relative gap of the NeRF's ray outputs
# the rows of a tile of `flash_backward_gap` (the CUDA kernels' 128-row
# and 128-key tiles)
BWD_TILE = 128


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool]) -> List[float]:
    """Each kept leaf's gap of norms relative to the reference's norm of
    that leaf or of the median kept leaf, whichever is larger (0 for the
    leaves left out)."""
    import numpy as np
    ref_a = np.asarray(ref, np.float64)
    med = float(np.median(ref_a[np.asarray(keep)]))
    return [abs(p - r) / max(r, med) if k else 0.0
            for p, r, k in zip(prog, ref, keep)]


def kept_leaves(ref_grad_norms: Sequence[float]) -> List[bool]:
    import numpy as np
    med = float(np.median(np.asarray(ref_grad_norms, np.float64)))
    return [g >= 1e-3 * med for g in ref_grad_norms]


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-12)


def render_gap(side: Dict, ref: Dict) -> float:
    """The first step's widest relative gap of the render losses (0 where
    the configuration renders nothing)."""
    first, ref_first = side["losses"][0], ref["losses"][0]
    return max([_rel(first[h], ref_first[h]) for h in RENDER_HEADS
                if h in ref_first], default=0.0)


def aligned_gap(torch, prog, ref) -> float:
    """The relative L2 gap of two embeddings [B, H, W, C] after the best
    orthogonal map of the program's C channels onto the reference's, image
    by image: a PCA's channels are defined up to such a map where its
    singular values lie close, so only what no map of the channels mends
    is a gap."""
    b, c = ref.shape[0], ref.shape[-1]
    p, r = prog.reshape(b, -1, c), ref.reshape(b, -1, c)
    u, _, vh = torch.linalg.svd(p.transpose(1, 2) @ r)
    return float(torch.linalg.norm(p @ (u @ vh) - r) / torch.linalg.norm(r))


def kept_gaps(side: Dict, ref: Dict, key: str) -> List[float]:
    """The relative L2 gap of each array a side kept under `key` (the
    first step's self-attention outputs, a block each; the NeRF's ray
    outputs) to the reference's (none where no side kept them)."""
    import numpy as np
    return [float(np.linalg.norm(a - r) / np.linalg.norm(r))
            for a, r in zip(side.get(key, ()), ref.get(key, ()))]


def flash_backward_gap(torch, calls: Sequence[Dict], device):
    """The widest gap of the program's flash backward over `calls` (each a
    call's operands q, k, v, the gradient of its output `dout`, its
    dropout rate, seed and block, and the dq, dk, dv the backward gave):
    each gradient is cut into tiles of `BWD_TILE` rows a head, and a
    tile's gap is the L2 norm of its error against the float64 gradient
    (`reference.flash.attention_grads_float64`) over the root mean square
    of the tiles' float64 norms, so that a tile the backward skips reads
    about 1 and one of no weight cannot blow up. None where no call's
    backward ran."""
    from .reference.flash import attention_grads_float64
    worst = None
    for c in calls:
        if not all(k in c for k in ("dout", "dq", "dk", "dv")):
            continue
        args = [c[k].to(device) for k in ("q", "k", "v", "dout")]
        want = attention_grads_float64(*args, c["rate"], c["seed"],
                                       c["block_q"])
        for key, w in zip(("dq", "dk", "dv"), want):
            b, h, n, d = w.shape
            t = min(BWD_TILE, n)
            tiles = lambda x: x.reshape(b, h, n // t, t * d).norm(dim=-1)
            err = tiles(c[key].to(device).double() - w)
            rms = tiles(w).pow(2).mean().sqrt().clamp(min=1e-300)
            gap = float(err.max() / rms)
            worst = gap if worst is None else max(worst, gap)
        del args, want
    return worst


def lamb_step_gaps(torch, rec: Dict, m, device) -> List[float]:
    """Each leaf's relative L2 gap between the program's first LAMB update
    (`rec`: each leaf's `p0`, the optimizer's first moment `m` after the
    step and the change `delta`, on the host) and the reference's LAMB
    (`reference/optimizers.py`, the configuration's `method` group `m`)
    applied in float64 to the same parameters and gradient; `lamb_step` is
    the widest."""
    from .reference.optimizers import Lamb
    p0 = [p.to(device, torch.float64) for p in rec["p0"]]
    params = [p.clone() for p in p0]
    opt = Lamb(params, m.lr, weight_decay=m.lambda_weight_l2,
               grad_clip_norm=m.grad_clip_norm)
    for p, mu in zip(params, rec["m"]):
        p.grad = mu.to(device, torch.float64) / (1.0 - opt.b1)
    opt.step()
    gaps = []
    for p, q, d in zip(params, p0, rec["delta"]):
        want = p - q
        err = float(torch.linalg.norm(d.to(device, torch.float64) - want))
        gaps.append(err / max(float(torch.linalg.norm(want)), 1e-30)
                    if err > 0.0 else 0.0)
    return gaps


def training_numbers(prog: Dict, ref: Dict, witness: Dict,
                     names: Sequence[str]) -> Dict[str, float]:
    """`prog`, `ref`, `witness`: each side's `losses` (a dict a step),
    `grad_norms` and `change_norms` (a norm a leaf), `attn_out` (the
    first step's self-attention outputs, a block each) and, where the
    configuration renders with the NeRF, `nerf_rays` (its ray outputs);
    `prog` may hold `attn_bwd` (`flash_backward_gap`) and `lamb_step`
    (`lamb_step_gaps`); `names` the leaves'."""
    import numpy as np
    rel = _rel
    keep = kept_leaves(ref["grad_norms"])
    kept = lambda g, sel=keep: [x for x, k in zip(g, sel) if k]
    med = lambda side, key, sel=keep: float(np.median(kept(leaf_gaps(
        side[key + "_norms"], ref[key + "_norms"], keep), sel)))
    prog_losses, ref_losses = prog["losses"], ref["losses"]
    widest = lambda side, key: max(kept_gaps(side, ref, key), default=0.0)
    attn_gap, attn_gap_bf16 = widest(prog, "attn_out"), widest(witness,
                                                               "attn_out")
    grad_median, grad_median_bf16 = med(prog, "grad"), med(witness, "grad")
    out = {"grad": grad_median / max(grad_median_bf16, 1e-12),
           "attn": attn_gap / max(attn_gap_bf16, ATTN_FLOOR),
           "change": med(prog, "change"),
           "render": render_gap(prog, ref) / max(render_gap(witness, ref),
                                                 RENDER_FLOOR),
           "render_gap": render_gap(prog, ref),
           "render_gap_bf16": render_gap(witness, ref),
           "grad_median": grad_median, "grad_median_bf16": grad_median_bf16,
           "attn_gap": attn_gap, "attn_gap_bf16": attn_gap_bf16,
           "grad_worst_leaf": max(leaf_gaps(prog["grad_norms"],
                                            ref["grad_norms"], keep)),
           "change_worst_leaf": max(leaf_gaps(prog["change_norms"],
                                              ref["change_norms"], keep)),
           "loss": max(rel(p["total_loss"], r["total_loss"])
                       for p, r in zip(prog_losses, ref_losses)),
           "loss_step1": rel(prog_losses[0]["total_loss"],
                             ref_losses[0]["total_loss"])}
    for key in ("attn_bwd", "lamb_step"):
        if prog.get(key) is not None:
            out[key] = prog[key]
    if ref.get("nerf_rays"):
        gap, gap_bf16 = widest(prog, "nerf_rays"), widest(witness, "nerf_rays")
        out.update(nerf_rays=gap / max(gap_bf16, RAYS_FLOOR),
                   nerf_rays_gap=gap, nerf_rays_gap_bf16=gap_bf16)
    ours = [n.startswith(RENDERER_PREFIX) for n in names]
    renderer = [k and r for r, k in zip(ours, keep)]
    if not any(renderer):   # all nought to rounding against the policy's
        renderer = ours
    if any(renderer):
        # the renderer's leaves against their own median leaf
        group = lambda side: float(np.median(kept(leaf_gaps(
            side["grad_norms"], ref["grad_norms"], renderer), renderer)))
        gap, gap_bf16 = group(prog), group(witness)
        out.update(grad_renderer=gap / max(gap_bf16, RENDERER_FLOOR),
                   grad_renderer_gap=gap, grad_renderer_gap_bf16=gap_bf16)
    for key in ("gt_embed", "gt_embed_plain"):
        if key in ref:
            out[key] = ref[key]
    for head in LOSS_HEADS:
        if head in ref_losses[0]:
            out[head] = max(rel(p[head], r[head])
                            for p, r in zip(prog_losses, ref_losses))
    return out


def action_gap(torch, q_ref, chosen) -> float:
    """q_ref: the reference's (q_trans [1, V³], q_rot_grip [1, 3R+2],
    q_collision [1, 2]); chosen: the program's (trans flat index, 3
    rotation indices, grip, collision)."""
    q_trans, q_rg, q_coll = (x[0].double() for x in q_ref)
    trans, rots, grip, coll = chosen
    nrot = (q_rg.shape[0] - 2) // 3
    s_trans = float(q_trans.std())
    s_rest = float(torch.cat([q_rg, q_coll]).std())
    gaps = [(float(q_trans.max() - q_trans[trans])) / s_trans]
    heads = [q_rg[i * nrot:(i + 1) * nrot] for i in range(3)]
    heads += [q_rg[3 * nrot:], q_coll]
    for h, c in zip(heads, [*rots, grip, coll]):
        gaps.append(float(h.max() - h[c]) / s_rest)
    return max(gaps)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number with a limit is compared; a number
    that is not finite fails."""
    import math
    checks, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        checks.append([name, v, lim])
    return ok, checks
