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
"""

from __future__ import annotations

import contextlib

FAULTS = ("render", "next_render", "nerf_render", "gt_embed")


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
    else:
        raise ValueError(f"no fault named {name!r}; the faults: {FAULTS}")
