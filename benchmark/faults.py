"""Faults planted in the program underneath the timed path, for the output
check's readings (`calibrate.py --faults`) and its tests. Each patches the
port's own code for as long as it is planted:

  render       this frame's splat render with the lower half of its rows
               left at the background, as a blend that skips half its tiles
  next_render  the same in the next frame's render (the dynamic tiers)
  nerf_render  the NeRF's fine pass with the colour of every other ray left
               at the other background (white for black), as a composite
               that skips rays over a buffer cleared to the wrong colour
               (GNFactor)
  gt_embed     the semantic tower's GT embedding with its rows and columns
               swapped, as a layout mixed up between the tower and the loss
  flash_forward  the policy's flash self-attention with the values of keys
               128-255 read as zeros while the row sums still count those
               keys, as a forward whose P·V skips its second 128-key tile
               (nothing to skip where N is 128 or less)
  flash_backward  the policy's flash self-attention with the gradient of
               queries 128-255 (of every query where N is 128 or less) left
               at zero in dq, as a backward whose dQ pass skips its second
               128-row tile
  lamb_trust   LAMB's update with its trust ratio taken as 1 (an Adam step
               in its place), as a step that drops the per-leaf norms
"""

from __future__ import annotations

import contextlib

FAULTS = ("render", "next_render", "nerf_render", "gt_embed",
          "flash_forward", "flash_backward", "lamb_trust")
# the keys whose values `flash_forward` drops: the CUDA forward's second tile
SKIPPED_KEYS = slice(128, 256)
# the queries whose dq `flash_backward` leaves at zero: the dQ pass's second
# tile
SKIPPED_QUERIES = slice(128, 256)


def _half_rows(color):
    mask = color.new_ones(color.shape)
    mask[:, color.shape[1] // 2:] = 0.0
    return color * mask


@contextlib.contextmanager
def planted(name: str):
    if name in ("render", "next_render"):
        from manigaussian_tpu_torch.rendering.neural_renderer import \
            NeuralRenderer as N
        which = FAULTS.index(name)
        forward, render = N.forward, N._render

        def counted_forward(self, *a, **k):
            self.renders_so_far = 0
            return forward(self, *a, **k)

        def broken_render(self, *a, **k):
            out = render(self, *a, **k)
            self.renders_so_far += 1
            if self.renders_so_far - 1 != which:
                return out
            return (_half_rows(out[0]),) + tuple(out[1:])

        N.forward, N._render = counted_forward, broken_render
        try:
            yield
        finally:
            N.forward, N._render = forward, render
    elif name == "nerf_render":
        from manigaussian_tpu_torch.rendering.nerf_renderer import \
            GNFactorNeRFRenderer as G
        render_rays = G.render_rays

        def broken_render_rays(self, *a, **k):
            coarse, fine = render_rays(self, *a, **k)
            # not the background, so that the fault shows whether the ray
            # hits something or nothing
            other = 0.0 if self.white_bkgd else 1.0
            keep = fine.rgb.new_ones(fine.rgb.shape[:-1] + (1,))
            keep[:, 1::2] = 0.0
            return coarse, fine._replace(
                rgb=fine.rgb * keep + other * (1 - keep))

        G.render_rays = broken_render_rays
        try:
            yield
        finally:
            G.render_rays = render_rays
    elif name == "gt_embed":
        import numpy as np

        import manigaussian_tpu_torch.models.foundation as F
        make = F.make_embed_fn

        def broken_make(*a, **k):
            embed = make(*a, **k)
            return lambda rgb: np.ascontiguousarray(embed(rgb).swapaxes(1, 2))

        F.make_embed_fn = broken_make
        try:
            yield
        finally:
            F.make_embed_fn = make
    elif name == "flash_forward":
        import manigaussian_tpu_torch.models.perceiver as P
        attend = P.flash_self_attention

        def skipping(q, k, v, *a, **kw):
            keep = v.new_ones(v.shape[2], 1)
            keep[SKIPPED_KEYS] = 0
            return attend(q, k, v * keep, *a, **kw)

        P.flash_self_attention = skipping
        try:
            yield
        finally:
            P.flash_self_attention = attend
    elif name == "flash_backward":
        import torch

        import manigaussian_tpu_torch.models.perceiver as P
        attend = P.flash_self_attention

        class SkipTile(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q):
                return q.view_as(q)

            @staticmethod
            def backward(ctx, dq):
                dq = dq.clone()
                rows = SKIPPED_QUERIES if dq.shape[2] > 128 else slice(None)
                dq[:, :, rows] = 0
                return dq

        def skipping(q, k, v, *a, **kw):
            return attend(SkipTile.apply(q), k, v, *a, **kw)

        P.flash_self_attention = skipping
        try:
            yield
        finally:
            P.flash_self_attention = attend
    elif name == "lamb_trust":
        import torch

        import manigaussian_tpu_torch.utils.optimizers as O
        step = O.Lamb.step

        @torch.no_grad()
        def untrusted(self):
            grads = self._grads()
            if self.grad_clip_norm > 0:
                O.clip_by_global_norm_(grads, self.grad_clip_norm)
            lr = self.current_lr()
            for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
                m.copy_(self.b1 * m + (1 - self.b1) * g)
                v.copy_(self.b2 * v + (1 - self.b2) * g * g)
                upd = m / (torch.sqrt(v) + self.eps)
                if self.weight_decay != 0.0:
                    upd = upd + self.weight_decay * p
                p.add_(-lr * upd)
            self.count += 1

        O.Lamb.step = untrusted
        try:
            yield
        finally:
            O.Lamb.step = step
    else:
        raise ValueError(f"no fault named {name!r}; the faults: {FAULTS}")
