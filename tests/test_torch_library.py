"""The port's library modules that no training path uses, against the JAX
package on the same seeded numpy inputs, on the CPU: `ops/knn.py`,
`models/attention3d.py` (through `convert.attention3d_state_dict`) and
`ops/losses.{l1_loss, masked_l1_loss, ssim,
softmax_cross_entropy_with_onehot}`; and the Chrome trace of
`utils/profiling.capture_trace`.

Tolerances: knn and the losses within 1e-6 relative (fp32; the knn inputs
are whole multiples of 2^-6, so |a|² + |b|² − 2a·b is exact in either order
of summation and the cancellation cannot amplify rounding), except ssim,
within 1e-5 relative: XLA's exp and torch's round some of the Gaussian
window's taps an ulp apart, the two depthwise convs sum in other orders,
and the variances E[x²] − μ² cancel, which amplifies both (measured up to
2.8e-6 on these inputs; 1.1e-6 with JAX's own window values);
attention3d's output and gradients (inputs and parameters) within 1e-5 of
their scale (fp32 through softmaxes, LayerNorms and a tanh GELU).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.models import attention3d as JA
from manigaussian_tpu.ops import knn as JK
from manigaussian_tpu.ops import losses as JL
from manigaussian_tpu_torch import convert as TC
from manigaussian_tpu_torch.models import attention3d as TA
from manigaussian_tpu_torch.ops import knn as TK
from manigaussian_tpu_torch.ops import losses as TL
from manigaussian_tpu_torch.utils import profiling as TP
from tests.torch_port_helpers import random_flax_params

REL = 1e-6
SSIM_REL = 1e-5
SCALE_TOL = 1e-5


@pytest.mark.parametrize("n,k,block", [(2000, 3, 512), (2048, 5, 4096),
                                       (7, 3, 4)])
def test_knn_matches_jax(n, k, block):
    rng = np.random.default_rng(n)
    pts = (np.round(rng.standard_normal((n, 3)) * 64) / 64).astype(np.float32)
    want = np.asarray(JK.knn_mean_sq_dist(jnp.asarray(pts), k=k, block=block))
    got = TK.knn_mean_sq_dist(torch.from_numpy(pts), k=k, block=block).numpy()
    assert got.shape == (n,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def test_knn_keeps_the_tf32_flag():
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        TK.knn_mean_sq_dist(torch.zeros(5, 3) + torch.arange(5.)[:, None])
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_attention3d_forward_and_gradients_match_jax():
    heads, dim_head, c, cl = 2, 8, 16, 12
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 5, c)).astype(np.float32)
    lang = rng.standard_normal((2, 7, cl)).astype(np.float32)
    jm = JA.Visual3DLangTransformer(heads=heads, dim_head=dim_head)
    params = random_flax_params(jm, jnp.asarray(x), jnp.asarray(lang))
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx, ll):
        return jnp.sum(jm.apply(p, xx, ll) * jnp.asarray(w))

    jout = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(lang)))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(x),
                                             jnp.asarray(lang))

    tm = TA.Visual3DLangTransformer(c, cl, heads=heads, dim_head=dim_head)
    tm.load_state_dict(TC.attention3d_state_dict(params))
    tx = torch.from_numpy(x).requires_grad_()
    tl = torch.from_numpy(lang).requires_grad_()
    tout = tm(tx, tl)
    (tout * torch.from_numpy(w)).sum().backward()

    def close(a, b, name):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=SCALE_TOL * scale, rtol=0,
                                   err_msg=name)

    close(tout.detach().numpy(), jout, "output")
    close(tx.grad.numpy(), np.asarray(jg[1]), "d x")
    close(tl.grad.numpy(), np.asarray(jg[2]), "d lang")
    want = TC.attention3d_state_dict(jg[0])
    for name, p in tm.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), name)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(size=(2, 24, 20, 3)).astype(np.float32)
            for _ in range(2))
    mask = (rng.uniform(size=(2, 24, 20, 1)) > 0.3).astype(np.float32)
    logits = rng.standard_normal((4, 9)).astype(np.float32) * 3
    onehot = np.eye(9, dtype=np.float32)[rng.integers(0, 9, 4)]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (TL.l1_loss(ta, tb), JL.l1_loss(a, b), REL),
        (TL.masked_l1_loss(ta, tb, torch.from_numpy(mask)),
         JL.masked_l1_loss(a, b, mask), REL),
        (TL.ssim(ta, tb), JL.ssim(ja, jb), SSIM_REL),
        (TL.ssim(ta, ta), JL.ssim(ja, ja), SSIM_REL),
        (TL.ssim(ta, tb, window_size=7), JL.ssim(ja, jb, window_size=7),
         SSIM_REL),
        (TL.softmax_cross_entropy_with_onehot(torch.from_numpy(logits),
                                              torch.from_numpy(onehot)),
         JL.softmax_cross_entropy_with_onehot(logits, onehot), REL),
    ]
    for i, (got, want, rel) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), rtol=rel, atol=0,
                                   err_msg=f"loss {i}")


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with TP.capture_trace(str(tmp_path / "trace")):
        with TP.trace_annotation("port_range"):
            (x @ x).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_range" for e in events)
