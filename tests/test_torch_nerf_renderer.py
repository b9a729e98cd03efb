"""The port's GNFactor NeRF renderer (`manigaussian_tpu_torch/rendering/
nerf_renderer.py`) against the JAX package's on the CPU.

The same draws for both packages: the port takes every draw of a render in
`GNFactorNeRFRenderer.sample_draws`, which the tests replace with numpy
tables; the JAX module draws through the `jax.random` functions it looks up
by the module-global name `jax`, which the tests replace (a pytest
`monkeypatch` of `manigaussian_tpu.rendering.nerf_renderer.jax`, nothing of
the package is edited) with `DrawShim`: its keys are sample indices and its
draws are rows of the same tables.

Tolerances: fp32 throughout, 1e-5 relative to each output's scale (the
same formulas; XLA and PyTorch sum the MLP's products in other orders);
with a bf16 volume, the outputs and the gradients of the fp32 inputs 1e-4.
The bf16 volume's own gradient is summed in bf16 by XLA (each corner's
cotangent rounded to bf16, eight scatter-adds in bf16) and in fp32 then
rounded once by the port, so it is held to bf16's resolution: 2^-6 of its
scale (a few bf16 steps of the summed cotangents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manigaussian_tpu.rendering import nerf_renderer as JN
from manigaussian_tpu_torch import convert
from manigaussian_tpu_torch.rendering import nerf_renderer as TN
from tests.torch_port_helpers import random_flax_params, to_np

BOUNDS = (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6)
SMALL = dict(image_width=12, image_height=10, n_coarse=8, n_fine=6,
             n_fine_depth=2, ray_chunk_size=16, d_latent=8, d_embed=3,
             d_hidden=16, n_blocks=2, combine_layer=1)


def scaled_close(actual, expected, tol, err_msg=""):
    """|actual − expected| ≤ tol · max(1e-3, max |expected|)."""
    a, e = to_np(actual), to_np(expected)
    scale = max(1e-3, float(np.abs(e).max()))
    np.testing.assert_allclose(a, e, atol=tol * scale, rtol=0, err_msg=err_msg)


def make_draws(seed, b, r, n_coarse, n_fine, n_fine_depth, hw):
    rng = np.random.default_rng(seed)
    nf = n_fine - n_fine_depth
    f = np.float32
    return {"ray_idx": rng.integers(0, hw, (b, r)),
            "coarse": rng.uniform(size=(b, r, n_coarse)).astype(f),
            "fine": rng.uniform(size=(b, r, nf)).astype(f),
            "fine_jitter": rng.uniform(size=(b, r, nf)).astype(f),
            "depth": rng.standard_normal((b, r, n_fine_depth)).astype(f)}


class DrawShim:
    """Stands in for the module-global `jax` of the JAX NeRF module. A key
    is a sample index: `split` of a real PRNG key gives the indices 0..num-1
    (render_rays' five-way split of a real key, in `render_image`, gives
    sample 0 five times); `split` of an index repeats it. The uniforms of
    one `render_rays` come in its order (coarse, importance, jitter), the
    normals are the depth draws, `randint` the ray indices, each the row of
    `draws` of the key's sample. Everything else is `jax`'s."""

    def __init__(self, draws):
        self.tables = {k: jnp.asarray(v) for k, v in draws.items()}
        self.random = self
        self._uniforms = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def split(self, key, num=2):
        if jnp.asarray(key).dtype == jnp.uint32:       # a real PRNG key
            if num == 5:
                self._uniforms = ["coarse", "fine", "fine_jitter"]
                return jnp.zeros((5,), jnp.int32)
            return jnp.arange(num, dtype=jnp.int32)
        if num == 5:
            self._uniforms = ["coarse", "fine", "fine_jitter"]
        return jnp.stack([key] * num)

    def fold_in(self, key, data):
        return key

    def uniform(self, key, shape, *a, **k):
        table = self.tables[self._uniforms.pop(0)][key]
        assert table.shape == tuple(shape)
        return table

    def normal(self, key, shape, *a, **k):
        table = self.tables["depth"][key]
        assert table.shape == tuple(shape)
        return table

    def randint(self, key, shape, minval, maxval, *a, **k):
        return self.tables["ray_idx"][key].astype(jnp.int32)


def torch_draws(draws, device="cpu"):
    t = lambda k: torch.as_tensor(draws[k], device=device)
    return TN.NerfDraws(t("ray_idx") if "ray_idx" in draws else None,
                        t("coarse"), t("fine"), t("fine_jitter"), t("depth"))


def feed_draws(monkeypatch, draws, image_draws=None):
    """Both packages draw `draws` (training renders) and `image_draws`
    (the full-image render's one set, [1, chunk, ·])."""
    monkeypatch.setattr(JN, "jax", DrawShim(
        draws if image_draws is None else image_draws))

    def fixed(self, generator, b, r, training, with_rays=True):
        src = draws if with_rays else image_draws
        return torch_draws({k: v for k, v in src.items()
                            if with_rays or k != "ray_idx"})

    monkeypatch.setattr(TN.GNFactorNeRFRenderer, "sample_draws", fixed)


def cameras(b, seed=0, w=12, h=10):
    rng = np.random.default_rng(seed)
    f = np.float32
    intr = np.zeros((b, 3, 3), f)
    intr[:, 0, 0] = rng.uniform(10, 14, b)
    intr[:, 1, 1] = rng.uniform(10, 14, b)
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 2, 2] = w / 2, h / 2, 1.0
    pose = np.tile(np.eye(4, dtype=f), (b, 1, 1))
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        pose[i, :3, :3] = 0.2 * q * np.sign(np.linalg.det(q)) + 0.8 * np.eye(3)
        pose[i, :3, :3] /= np.linalg.norm(pose[i, :3, :3], axis=0)
        pose[i, :3, 3] = [0.2, 0.0, 0.2] + 0.05 * rng.standard_normal(3)
    return intr, pose


def test_gen_rays_matches_jax():
    intr, pose = cameras(3, seed=1, w=12, h=10)
    ours = TN.gen_rays(torch.from_numpy(pose), torch.from_numpy(intr), 12, 10,
                       0.1, 4.0)
    assert ours.shape == (3, 120, 8)
    for i in range(3):
        theirs = JN.gen_rays(jnp.asarray(pose[i]), jnp.asarray(intr[i]), 12,
                             10, 0.1, 4.0)
        scaled_close(ours[i], theirs, 1e-6, f"camera {i}")
        scaled_close(TN.gen_rays(torch.from_numpy(pose[i]),
                                 torch.from_numpy(intr[i]), 12, 10, 0.1, 4.0),
                     theirs, 1e-6, f"unbatched {i}")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_trilinear_sample_and_its_gradients_match_jax(dtype, tol):
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((2, 5, 4, 6, 3)).astype(np.float32)
    # inside, on the border, and outside [0, 1]³ (clamped to the border)
    uvw = rng.uniform(-0.2, 1.2, (2, 40, 3)).astype(np.float32)
    uvw[:, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 1.0, 0.0], [1.0, 0.25, 0.75]]
    cot = rng.standard_normal((2, 40, 3)).astype(np.float32)

    jdt = jnp.dtype(dtype)
    outs, grads_v, grads_u = [], [], []
    for i in range(2):
        jv = jnp.asarray(vol[i]).astype(jdt)
        out, vjp = jax.vjp(JN.trilinear_sample, jv, jnp.asarray(uvw[i]))
        gv, gu = vjp(jnp.asarray(cot[i]))
        outs.append(np.asarray(out, np.float32))
        grads_v.append(np.asarray(gv.astype(jnp.float32)))
        grads_u.append(np.asarray(gu))

    tv = torch.from_numpy(vol).to(getattr(torch, dtype)).requires_grad_()
    tu = torch.from_numpy(uvw).requires_grad_()
    out = TN.trilinear_sample(tv, tu)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(cot))
    assert tv.grad.dtype == getattr(torch, dtype)
    scaled_close(out, np.stack(outs), tol, "values")
    scaled_close(tu.grad, np.stack(grads_u), tol, "d uvw")
    scaled_close(tv.grad.float(), np.stack(grads_v),
                 tol if dtype == "float32" else 2.0 ** -6, "d volume")
    # the clamp: a point outside reads the border value, its uvw gradient 0
    outside = (uvw < 0) | (uvw > 1)
    assert np.all(tu.grad.numpy()[outside] == 0)


def test_trilinear_backward_is_a_fixed_order_sum():
    rng = np.random.default_rng(3)
    vol = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 5)).astype(
        np.float32)).requires_grad_()
    uvw = torch.from_numpy(rng.uniform(0, 1, (1, 300, 3)).astype(np.float32))
    grads = []
    for _ in range(2):
        vol.grad = None
        TN.trilinear_sample(vol, uvw).sum().backward()
        grads.append(vol.grad.clone())
    assert torch.equal(*grads)
    # against the same sum in float64
    v64 = vol.detach().double().requires_grad_()
    TN.trilinear_sample(v64, uvw.double()).sum().backward()
    np.testing.assert_allclose(grads[0].numpy(),
                               v64.grad.numpy().astype(np.float32),
                               rtol=1e-5, atol=1e-5)


def renderers(**kw):
    cfg = dict(SMALL, **kw)
    jr = JN.GNFactorNeRFRenderer(coordinate_bounds=BOUNDS, **cfg)
    tr = TN.GNFactorNeRFRenderer(BOUNDS, **cfg)
    return cfg, jr, tr


def scene(b=2, v=6, seed=4):
    cfg = SMALL
    rng = np.random.default_rng(seed)
    f = np.float32
    intr, pose = cameras(b, seed, cfg["image_width"], cfg["image_height"])
    hw = (cfg["image_height"], cfg["image_width"])
    return {"vf": rng.standard_normal((b, v, v, v, cfg["d_latent"])).astype(f),
            "rgb": rng.uniform(size=(b, *hw, 3)).astype(f),
            "pose": pose, "intr": intr,
            "embed": rng.standard_normal((b, *hw, cfg["d_embed"])).astype(f)}


def flax_params(jr, s):
    j = {k: jnp.asarray(v) for k, v in s.items()}
    return random_flax_params(jr, j["vf"], j["rgb"], j["pose"], j["intr"],
                              j["embed"], jax.random.PRNGKey(0), seed=5)


def test_flax_weights_convert_one_to_one():
    cfg, jr, tr = renderers()
    params = flax_params(jr, scene())
    sd = convert.renderer_state_dict(params["params"])
    missing, unexpected = tr.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    n_flax = sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tr.parameters())
    # flax names nested modules outer-first: neural_renderer/nerf/mlp/...
    assert set(params["params"]) == {"nerf"}
    assert "lin_z_0" in params["params"]["nerf"]["mlp"]


def test_composite_matches_jax():
    cfg, jr, tr = renderers()
    s = scene()
    params = flax_params(jr, s)
    tr.load_state_dict(convert.renderer_state_dict(params["params"]))
    rng = np.random.default_rng(6)
    rays = np.asarray(JN.gen_rays(jnp.asarray(s["pose"][0]),
                                  jnp.asarray(s["intr"][0]), 12, 10, 0.1,
                                  4.0))[:16]
    z = np.sort(rng.uniform(0.1, 4.0, (16, 9)).astype(np.float32), -1)
    theirs = jr.apply(params, jnp.asarray(s["vf"][0]), jnp.asarray(rays),
                      jnp.asarray(z), None, False,
                      method=JN.GNFactorNeRFRenderer._composite)
    ours = tr._composite(torch.from_numpy(s["vf"][:1]),
                         torch.from_numpy(rays)[None], torch.from_numpy(z)[None],
                         None)
    for name in ("rgb", "embed", "depth", "weights"):
        scaled_close(getattr(ours, name)[0], getattr(theirs, name), 1e-5, name)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_losses_and_gradients_match_jax(monkeypatch, dtype, tol):
    """The training call (random ray chunk, coarse + fine, four MSE terms and
    PSNR) on a batch of 2, and the gradients of its loss to every MLP
    parameter and the voxel features."""
    cfg, jr, tr = renderers()
    s = scene()
    params = flax_params(jr, s)
    tr.load_state_dict(convert.renderer_state_dict(params["params"]))
    hw = cfg["image_width"] * cfg["image_height"]
    draws = make_draws(7, 2, cfg["ray_chunk_size"], cfg["n_coarse"],
                       cfg["n_fine"], cfg["n_fine_depth"], hw)
    feed_draws(monkeypatch, draws)

    jdt = jnp.dtype(dtype)

    def jloss(p, vf):
        nl = jr.apply(p, vf.astype(jdt), jnp.asarray(s["rgb"]),
                      jnp.asarray(s["pose"]), jnp.asarray(s["intr"]),
                      jnp.asarray(s["embed"]), jax.random.PRNGKey(1))
        return nl.loss, nl

    (_, jl), (jgp, jgv) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(s["vf"]))

    vf = torch.from_numpy(s["vf"]).requires_grad_()
    tl = tr(vf.to(getattr(torch, dtype)), torch.from_numpy(s["rgb"]),
            torch.from_numpy(s["pose"]), torch.from_numpy(s["intr"]),
            torch.from_numpy(s["embed"]), torch.Generator().manual_seed(0))
    tl.loss.backward()
    for name in TN.NerfLosses._fields:
        scaled_close(getattr(tl, name), getattr(jl, name), tol, name)
    jgrads = convert.renderer_state_dict(jax.device_get(jgp)["params"])
    for name, p in tr.named_parameters():
        scaled_close(p.grad, jgrads[name], tol, name)
    scaled_close(vf.grad, jgv, tol if dtype == "float32" else 2.0 ** -6,
                 "d voxel features")


def test_render_image_shape_padding_and_values(monkeypatch):
    """The full-image render: H·W = 120 rays in one chunk of IMAGE_CHUNK
    padded with the first ray, one set of draws for every chunk, no graph;
    equal to JAX's `render_image` on the same draws."""
    cfg, jr, tr = renderers()
    s = scene()
    params = flax_params(jr, s)
    tr.load_state_dict(convert.renderer_state_dict(params["params"]))
    image = make_draws(8, 1, TN.IMAGE_CHUNK, cfg["n_coarse"], cfg["n_fine"],
                       cfg["n_fine_depth"], 1)
    del image["ray_idx"]
    feed_draws(monkeypatch, {}, image_draws=image)
    jrgb, jdepth = jr.apply(params, jnp.asarray(s["vf"][0]),
                            jnp.asarray(s["pose"][0]),
                            jnp.asarray(s["intr"][0]), jax.random.PRNGKey(0),
                            method=JN.GNFactorNeRFRenderer.render_image)
    vf = torch.from_numpy(s["vf"][0]).requires_grad_()
    rgb, depth = tr.render_image(vf, torch.from_numpy(s["pose"][0]),
                                 torch.from_numpy(s["intr"][0]),
                                 torch.Generator().manual_seed(0))
    assert rgb.shape == (10, 12, 3) and depth.shape == (10, 12)
    assert not rgb.requires_grad
    scaled_close(rgb, jrgb, 1e-5, "rgb")
    scaled_close(depth, jdepth, 1e-5, "depth")


def test_render_image_chunks_share_one_set_of_draws():
    """With more rays than a chunk, every chunk renders with the same draws:
    a ray gives the same color in any chunk."""
    cfg = dict(SMALL, image_width=80, image_height=64)   # 5120 rays: 2 chunks
    tr = TN.GNFactorNeRFRenderer(BOUNDS, **cfg)
    from manigaussian_tpu_torch.models.blocks import initialize
    initialize(tr, torch.Generator().manual_seed(0))
    vf = torch.randn(6, 6, 6, cfg["d_latent"],
                     generator=torch.Generator().manual_seed(1))
    intr = torch.tensor([[60.0, 0, 40], [0, 60.0, 32], [0, 0, 1]])
    pose = torch.eye(4)
    rgb, depth = tr.render_image(vf, pose, intr, torch.Generator().manual_seed(0))
    assert rgb.shape == (64, 80, 3) and torch.isfinite(rgb).all()
    # the second chunk (rays 4096..5119, padded with ray 0) on its own
    rays = TN.gen_rays(pose, intr, 80, 64, 0.1, 4.0)
    chunk = torch.cat([rays[4096:], rays[:1].expand(4096 - 1024, 8)])
    draws = tr.sample_draws(torch.Generator().manual_seed(0), 1,
                            TN.IMAGE_CHUNK, False, with_rays=False)
    with torch.no_grad():
        _, fine = tr.render_rays(vf[None], chunk[None], draws)
    np.testing.assert_allclose(fine.rgb[0, :1024].numpy(),
                               rgb.reshape(-1, 3)[4096:].numpy(),
                               rtol=1e-6, atol=1e-6)
