"""LAMB's first update of a zero-initialized leaf, in JAX and in the port.

At full width GNFACTOR_BC's `rgb_loss` jumps after the first update, on the
card and on the CPU alike (`chip_smoke.py --gnf-steps`): the update that
moves it is the one of the NeRF MLP's zero-initialized `fc1` weights. LAMB
gives a leaf whose norm is 0 the trust ratio 1, so its first step is
lr · (1 − b1)·g / ((1 − b2)^½·|g| + ε) an element: about lr·√10 wherever
|g| is well above ε, whatever the gradient's scale, in the sign of the
gradient. Both packages' LAMB (`manigaussian_tpu/utils/optimizers.py`
`lamb_reference`, the port's `utils/optimizers.Lamb`) take that step, here
at the NeRF MLP's widths (fc1 512 × 512, a bias of 512) beside a leaf that
is not zero (trust ratio ‖w‖ / ‖u‖: a step of lr·min(‖w‖, 10)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.utils.optimizers import lamb_reference
from manigaussian_tpu_torch.utils.optimizers import Lamb

LR, WD = 5e-4, 1e-6     # GNFACTOR_BC.yaml: lr, lambda_weight_l2


@pytest.mark.parametrize("grad_scale", [1e-2, 1e-4, 1e-7])
def test_first_step_of_a_zero_leaf_is_lr_times_root_ten_in_both(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"fc1_weight": (512, 512), "fc1_bias": (512,), "fc0_weight": (512, 512)}
    params = {"fc1_weight": np.zeros(shapes["fc1_weight"], np.float32),
              "fc1_bias": np.zeros(shapes["fc1_bias"], np.float32),
              "fc0_weight": (0.06 * rng.standard_normal(shapes["fc0_weight"])
                             ).astype(np.float32)}
    grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}

    opt = lamb_reference(LR, weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    updates, _ = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                            opt.init(jp), jp)
    j_step = {k: np.asarray(v) for k, v in updates.items()}

    tp = {k: torch.tensor(v) for k, v in params.items()}
    lamb = Lamb(list(tp.values()), LR, weight_decay=WD)
    for k, p in tp.items():
        p.grad = torch.tensor(grads[k])
    lamb.step()
    t_step = {k: (tp[k] - torch.tensor(params[k])).numpy() for k in tp}

    for k in shapes:
        # the port's step is read back as p_new − p, each rounded to float32:
        # one ulp of p on top of the steps' own rounding
        ulp = np.spacing(np.abs(params[k]).max()) if params[k].any() else 0.0
        scale = np.abs(j_step[k]).max()
        assert np.abs(t_step[k] - j_step[k]).max() <= 1e-5 * scale + ulp, k
    for k in ("fc1_weight", "fc1_bias"):
        g = grads[k].astype(np.float64)
        expect = -LR * 0.1 * g / (np.sqrt(0.001) * np.abs(g) + 1e-6)
        np.testing.assert_allclose(j_step[k], expect, rtol=1e-5, atol=1e-12)
        if grad_scale >= 1e-4:      # |g| ≫ ε: every element moves ≈ lr·√10
            moved = np.abs(j_step[k])[np.abs(g) > 100 * 1e-6 / np.sqrt(0.001)]
            assert np.allclose(moved, LR * np.sqrt(10.0), rtol=0.01)
    # a leaf that is not zero moves by lr·‖w‖ (trust ratio ‖w‖ / ‖u‖, the
    # weight norm clipped to 10)
    w_norm = min(np.linalg.norm(params["fc0_weight"]), 10.0)
    assert np.linalg.norm(j_step["fc0_weight"]) == pytest.approx(LR * w_norm,
                                                                 rel=1e-4)
