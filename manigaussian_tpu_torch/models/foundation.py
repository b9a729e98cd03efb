"""Foundation-model features for the semantic tiers (port of
`manigaussian_tpu/models/foundation.py`; reference `neural_rendering.py:117-166`,
`dino_extractor.py:10-34`).

A frozen vision tower gives dense features of the ground-truth view; a
per-image PCA compresses them to `d_embed` = 3 channels, which supervise the
rendered embedding image through the cosine loss. Providers:
  * `StubFeatureExtractor` — fixed random projections of multi-scale colour
    statistics (no weights); the projection is the JAX package's
    `jax.random.normal(PRNGKey(0), (12, 32)) / sqrt(12)`, shipped as
    constants (`STUB_PROJECTION`);
  * `SDVaeFeatureExtractor` — the ODISE 'diffusion' path: the SD VAE's last
    decoder tap (models/sd_vae.py), random weights from seed 0
    (`"random-init"`) or a CompVis checkpoint;
  * `models/dinov2.DinoV2Extractor` — DINOv2 patch tokens from a torch-hub
    state dict.

Every extractor maps [B, H, W, 3] in [0, 1] to [B, H, W, C] on its device,
under `torch.no_grad`. `embed_fn(d_embed)` wraps the whole GT-embed pipeline
(features → per-image PCA) as numpy → numpy [B, H, W, d_embed] float32 for
the batch iterator's prefetch thread; on a GPU it runs on a CUDA stream of
its own and copies the result to the host before it returns.

The PCA (`pca_lowrank_v`) draws its random test matrix from a
`torch.Generator` seeded 0, where JAX draws from PRNGKey(0): the two agree
on the subspace, and the projection up to a sign per channel, as
torch.pca_lowrank does against either. No sign is canonicalized; JAX does
none.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from manigaussian_tpu_torch.ops.resize import resize_bilinear
from manigaussian_tpu_torch.utils.device import DeviceLike, resolve_device

# the input size of the SD VAE (ODISE's diffusion_preprocess resize)
FEATURE_HW = 512
# seed of the PCA's random test matrix and of the random-init SD VAE
SEED = 0

# jax.random.normal(jax.random.PRNGKey(0), (12, 32)) / np.sqrt(12), float32
# (the JAX StubFeatureExtractor's `_w`; each literal is the shortest decimal
# that rounds to its float32, so the table is equal bit for bit)
STUB_PROJECTION = (
    (0.46841645, 0.5846436, -0.12516794, -0.022694875, 0.050833065,
     -0.28061798, -0.14298043, 0.14271481, 0.19178113, -0.27428856,
     0.62917626, -0.56440336, 0.103510454, 0.04555153, 0.3686626, 0.43603364,
     0.28020424, 0.17309195, 0.0071304794, -0.55323935, -0.5367479,
     0.49887222, 0.013622681, 0.2350185, 0.037911035, 0.08165091, 0.35899475,
     0.1992667, -0.231153, -0.2139054, -0.4442216, 0.08737961),
    (-0.005980207, 0.032703202, -0.063697524, 0.02035811, 0.24632528,
     -0.23722568, -0.0042187595, -0.043434687, -0.25984666, -0.21912542,
     0.096156284, 0.23361008, 0.012324279, -0.16675933, -0.11962667,
     -0.56039155, 0.37993065, 0.2177398, 0.046681456, -0.010055441,
     -0.38412294, 0.11362839, 0.13931341, 0.2320456, -0.1829383, 0.29986304,
     -0.21407898, -0.12411842, -0.064980894, -0.15001498, -0.48186132,
     0.19495802),
    (0.06564104, -0.34064898, -0.2819587, 0.34553272, -0.24285536, 0.19047011,
     0.30830964, 0.09105428, 0.12634273, 0.3382858, 0.26203328, 0.35294122,
     -0.15773073, 0.24719378, -0.0022995214, 0.13667011, -0.3201508,
     0.76278114, 0.25679854, 0.28728995, 0.07366908, 0.03607324, 0.3360678,
     0.05570381, -0.055135634, -0.12603404, -0.33087912, 0.057042934,
     0.33736467, -0.25212842, 0.2545562, -0.09933476),
    (-0.04218979, -0.26371098, 0.39551297, -0.22518899, 0.10531304, 0.2817874,
     -0.002070581, 0.060772482, 0.054951742, 0.110537365, -0.36535686,
     -0.42849624, -0.033065896, 0.3186147, 0.057292495, 0.061744537,
     -0.19067998, -0.20993035, 0.11675169, 0.05474937, -0.1741229, 0.272815,
     0.31288856, -0.59353733, -0.20606253, 0.17114633, 0.30333298,
     -0.42280048, 0.19052887, -0.087099575, 0.038431834, -0.09607491),
    (0.4532228, 0.16584736, 0.20883207, 0.20111549, -0.19174793, -0.5678115,
     -0.69751257, 0.07889536, 0.33495477, 0.07664692, 0.19944835, -0.07391939,
     -0.5839148, -0.17988183, 0.08069385, -0.38980302, 0.029239459,
     0.14799836, 0.07621586, -0.52802366, 0.4138959, 0.3807208, -0.43166247,
     0.26941356, 0.4068197, -0.048463866, -0.034243472, -0.07009751,
     -0.277636, -0.21834233, 0.7427108, -0.30604738),
    (0.09016164, 0.09454451, 0.023911607, -0.31254527, -0.2229249,
     -0.18319458, 0.35403416, -0.42926428, -0.22888158, 0.15967157,
     -0.34223583, 0.28200945, -0.12656972, -0.09519236, 0.0959981,
     -0.18842393, -0.34791481, -0.25585517, -0.60876894, -0.044754855,
     -0.18992862, -0.19146495, -0.009630795, -0.25863245, 0.022261703,
     -0.26264328, 0.36836448, -0.11595406, -0.28865355, 0.0050061983,
     0.11678118, -0.30926472),
    (0.2992587, -0.1929737, -0.022496995, 0.34872594, 0.5782583, -0.02038055,
     0.09700614, 0.6795542, -0.07019693, 0.33855966, 0.24418734, 0.21030298,
     0.17261207, -0.22132869, 0.05030374, -0.17965972, 0.23979464, 0.09571982,
     -0.25689432, 0.06106593, -0.026700098, -0.4667932, -0.11903475,
     0.4065375, 0.29823944, 0.31208503, -0.3318468, -0.009272796,
     -0.021554796, 0.17290087, -0.34356993, -0.18160532),
    (0.016042281, 0.1055491, 0.15778233, 0.2206924, -0.09806988, 0.10466489,
     -0.08573421, 0.29736593, 0.27873725, 0.21816927, 0.034991574, 0.2375205,
     0.1726355, -0.24175352, 0.1569541, -0.092965536, -0.12838277, 0.26403832,
     0.35004583, 0.51898986, -0.46340546, 0.023027802, -0.22201791,
     -0.56185716, 0.4599859, -0.26537672, -0.49542913, 0.32296956,
     0.058742978, -0.052026153, 0.05050571, -0.21209906),
    (0.118359424, -0.44256434, -0.49180624, 0.5891927, -0.059154868,
     -0.024420291, 0.1927526, -0.3996723, 0.109476976, -0.213674, 0.37605837,
     -0.29606298, 0.14330414, -0.20217179, -0.010582221, -0.12005937,
     -0.07186739, 0.26251224, -0.05427524, -0.20708866, 0.11249306,
     -0.060229454, -0.22502226, 0.3743852, -0.2637309, 0.03840616, 0.23590598,
     -0.13756633, 0.12056305, -0.002817792, -0.26790133, 0.18774863),
    (-0.9234131, 0.13430998, 0.09687508, 0.006190254, -0.07985673,
     0.012255035, -0.0867722, -0.18233904, -0.3540489, -0.20544823,
     -0.015574525, -0.60410553, 0.1367612, -0.4607987, -0.04444687,
     -0.7071223, 0.18756397, -0.20417401, 0.046223477, -0.45273694,
     0.06789658, 0.33570468, 0.12279848, -0.11344176, 0.21855912,
     -0.033077706, -0.31009853, -0.1870402, -0.2619224, 0.06411641,
     0.11413666, 0.051513743),
    (-0.016732825, 0.30282524, 0.38809976, -0.027989939, 0.026658475,
     0.24939835, 0.0003222027, -0.30469042, 0.31569555, -0.38589048,
     0.25800404, 0.011057374, -0.66706973, 0.0755285, 0.16632414, 0.20558645,
     0.03264321, -0.5239248, 0.30250123, -0.35586205, 0.014646694,
     -0.38673466, 0.6552176, 0.058820657, 0.15151371, -0.36295342,
     -0.12052555, 0.1819272, -0.14567299, 0.7378261, 0.016587539, 0.12668933),
    (-0.070351444, 0.37161794, 0.32955667, 0.15033363, 0.0626357, 0.32950136,
     0.25829628, 0.5222417, -0.55079937, -0.28849363, 0.20575854, -0.18316948,
     -0.03599426, 0.19786942, 0.28252286, -0.07864876, -0.36079124,
     -0.25716847, 0.029356077, 0.27350053, 0.028236212, 0.36334273, 0.3018767,
     -0.053571783, 0.1483361, -0.5674937, -0.17866954, -0.45956072,
     -0.22936866, 0.39040282, 0.037743554, 0.3127522),
)


def pca_omega(c: int, q: int) -> torch.Tensor:
    """The randomized PCA's test matrix Ω [c, q], standard normal, drawn on
    the CPU from a generator seeded `SEED`."""
    return torch.randn((c, q), generator=torch.Generator().manual_seed(SEED))


def pca_lowrank_v(features: torch.Tensor, q: int = 6) -> torch.Tensor:
    """Right singular vectors V [..., C, q] of the centred features
    [..., HW, C] by randomized SVD (torch.pca_lowrank's algorithm, niter 2):
    QR iterations on A·Ω, then a small SVD. Ω is `pca_omega`'s, one for
    every image of a batch, as JAX's vmap uses one key. Two iterations do not
    converge on a flat spectrum (the SD VAE's random-weight features), so
    there the result depends on Ω, in JAX as here."""
    hw, c = features.shape[-2:]
    q = min(q, hw, c)
    a = features - features.mean(dim=-2, keepdim=True)
    omega = pca_omega(c, q).to(features)
    at = a.transpose(-2, -1)
    qmat, _ = torch.linalg.qr(a @ omega)
    for _ in range(2):
        qh, _ = torch.linalg.qr(at @ qmat)
        qmat, _ = torch.linalg.qr(a @ qh)
    b = qmat.transpose(-2, -1) @ a                          # [..., q, C]
    _u, _s, vh = torch.linalg.svd(b, full_matrices=False)
    return vh.transpose(-2, -1)


def pca_to_channels(features: torch.Tensor, d_embed: int = 3,
                    method: str = "lowrank") -> torch.Tensor:
    """[..., HW, C] → [..., HW, d_embed]: the uncentred features projected
    on the top right singular vectors of the centred ones (A @ V[:, :d]), as
    neural_rendering.py:159-162. `method` 'lowrank' (randomized, q =
    max(6, d_embed)) or 'exact' (full SVD)."""
    if method == "lowrank":
        v = pca_lowrank_v(features, q=max(6, d_embed))[..., :d_embed]
    elif method == "exact":
        centred = features - features.mean(dim=-2, keepdim=True)
        _u, _s, vh = torch.linalg.svd(centred, full_matrices=False)
        v = vh.transpose(-2, -1)[..., :d_embed]
    else:
        raise ValueError(f"unknown PCA method {method!r}")
    return features @ v


def pca_to_channels_batch(features: torch.Tensor, d_embed: int = 3,
                          method: str = "lowrank") -> torch.Tensor:
    """[B, HW, C] → [B, HW, d_embed], one PCA per image."""
    return pca_to_channels(features, d_embed, method=method)


class FeatureExtractor:
    """A frozen tower on `device`: __call__([B, H, W, 3] in [0, 1]) → dense
    features [B, H, W, C]."""

    device: torch.device

    def embed_fn(self, d_embed: int = 3) -> Callable[[np.ndarray], np.ndarray]:
        return make_embed_fn(self, d_embed)


class StubFeatureExtractor(FeatureExtractor):
    """Dense features from fixed random projections of 12 colour statistics:
    the image, a [1, 2, 1]/4 blur of it (zero padded, along H then W), the
    difference of two blurs, and |∂x| + |∂y| with wrap-around differences."""

    out_channels = 32

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._w = torch.tensor(STUB_PROJECTION, dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _blur(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        pad = [0, 0] * (x.dim() - axis - 1) + [1, 1]
        p = F.pad(x, pad)
        return (0.25 * p.narrow(axis, 0, n) + 0.5 * p.narrow(axis, 1, n)
                + 0.25 * p.narrow(axis, 2, n))

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        def blur(x):
            return self._blur(self._blur(x, 1), 2)

        blur1 = blur(rgb)
        blur2 = blur(blur1)
        gx = torch.roll(rgb, -1, dims=2) - rgb
        gy = torch.roll(rgb, -1, dims=1) - rgb
        stats = torch.cat([rgb, blur1, blur2 - blur1,
                           gx.abs() + gy.abs()], dim=-1)
        return stats @ self._w


class SDVaeFeatureExtractor(FeatureExtractor):
    """The ODISE 'diffusion' features: resize to `feature_hw`² (512),
    normalize to [-1, 1], VAE encode → clean-latent decode → the last
    decoder tap ([B, 512, 128, 128] at 512²), resized back to the input.
    `checkpoint_path` None draws random weights from a generator seeded
    `SEED` (a resumed run rebuilds the same tower); a CompVis `.ckpt`/`.pt`
    loads by name, a `.msgpack` of `tools/convert_weights sd_vae` (either
    package's) through `convert.sd_vae_state_dict`."""

    def __init__(self, checkpoint_path: Optional[str],
                 feature_hw: Optional[int] = None, device: DeviceLike = None):
        from manigaussian_tpu_torch.models import sd_vae as sv

        self.device = resolve_device(device)
        self.feature_hw = feature_hw or FEATURE_HW
        if checkpoint_path is None:
            model = sv.SDVae().init_params(torch.Generator().manual_seed(SEED))
        elif str(checkpoint_path).endswith(".msgpack"):
            from manigaussian_tpu_torch.convert import sd_vae_state_dict
            from manigaussian_tpu_torch.tools.convert_weights import \
                load_converted
            payload = load_converted(checkpoint_path)
            model = sv.SDVae(**payload["dims"]).load_compvis(
                sd_vae_state_dict(payload["variables"]))
        else:
            obj = torch.load(checkpoint_path, map_location="cpu")
            sd = (obj.get("state_dict", obj) if isinstance(obj, dict)
                  else obj.state_dict())
            model = sv.SDVae(**sv.dims_from_state_dict(sd)).load_compvis(sd)
        self.model = model.requires_grad_(False).eval().to(self.device)

    @torch.no_grad()
    def __call__(self, rgb: torch.Tensor) -> torch.Tensor:
        h, w = rgb.shape[1:3]
        img = resize_bilinear(rgb, (self.feature_hw, self.feature_hw))
        out = self.model((img * 2.0 - 1.0).permute(0, 3, 1, 2))
        feats = out["decoder_features"][-1].permute(0, 2, 3, 1)
        return resize_bilinear(feats, (h, w))


def extract_gt_embed(rgb: torch.Tensor, extractor: FeatureExtractor,
                     d_embed: int = 3) -> torch.Tensor:
    """GT embedding image: dense features → per-image PCA →
    [B, H, W, d_embed]."""
    with torch.no_grad():
        feats = extractor(rgb)
        b, h, w, c = feats.shape
        proj = pca_to_channels_batch(feats.reshape(b, h * w, c), d_embed)
    return proj.reshape(b, h, w, d_embed)


def make_embed_fn(extractor: FeatureExtractor, d_embed: int = 3
                  ) -> Callable[[np.ndarray], np.ndarray]:
    """numpy rgb [B, H, W, 3] → numpy GT embed [B, H, W, d_embed] float32,
    for `BatchIterator(embed_fn=)`. On a GPU it runs on a CUDA stream of its
    own (the prefetch thread's work overlaps the train step's), ordered
    after the work already queued, the tower's weights among it; the result
    is copied to the host before the call returns. An error propagates to
    the caller."""
    dev = extractor.device
    stream = None                   # on the CPU: no stream, a no-op context
    if dev.type == "cuda":
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))

    def embed(rgb: np.ndarray) -> np.ndarray:
        with torch.cuda.stream(stream):
            x = torch.as_tensor(np.asarray(rgb, np.float32)).to(dev)
            return extract_gt_embed(x, extractor, d_embed).cpu().numpy()

    return embed


def create_feature_extractor(name: Optional[str],
                             checkpoint_dir: Optional[str] = None,
                             device: DeviceLike = None
                             ) -> Optional[FeatureExtractor]:
    """The factory of cfg.method.neural_renderer.foundation_model_name
    (None / 'diffusion' / 'dinov2') and its `foundation_checkpoint`, with the
    JAX package's routes and warnings:
      * 'dinov2' + a torch-hub `.pt` or a converted `.msgpack` file →
        DinoV2Extractor; a local
        Hugging Face directory → DinoV2DirExtractor (read without
        `transformers`); none → the stub, warned;
      * 'diffusion' + "random-init" → the SD VAE with random weights (the
        real compute, features not semantic); + a CompVis checkpoint or a
        converted `.msgpack` file → the SD VAE; none → the stub, warned;
      * any other name → the stub.
    The tower is built on `device` (the agent's)."""
    if name is None:
        return None
    if name == "dinov2":
        if checkpoint_dir and os.path.isfile(checkpoint_dir):
            from manigaussian_tpu_torch.models.dinov2 import DinoV2Extractor
            return DinoV2Extractor(checkpoint_dir, device=device)
        if checkpoint_dir and os.path.isdir(checkpoint_dir):
            from manigaussian_tpu_torch.models.dinov2 import \
                DinoV2DirExtractor
            return DinoV2DirExtractor(checkpoint_dir, device=device)
        if checkpoint_dir:
            raise FileNotFoundError(
                f"foundation_checkpoint={checkpoint_dir!r} is neither a "
                "torch-hub state dict file nor a DINOv2 directory")
        warnings.warn(
            "foundation_model_name='dinov2' without a checkpoint: semantic "
            "supervision falls back to StubFeatureExtractor statistics, NOT "
            "DINOv2 features. Provide neural_renderer.foundation_checkpoint.",
            UserWarning, stacklevel=2)
        return StubFeatureExtractor(device=device)
    if name == "diffusion":
        if checkpoint_dir == "random-init":
            return SDVaeFeatureExtractor(None, device=device)
        if checkpoint_dir and os.path.isfile(checkpoint_dir):
            return SDVaeFeatureExtractor(checkpoint_dir, device=device)
        warnings.warn(
            "foundation_model_name='diffusion' without a checkpoint: "
            "semantic supervision falls back to StubFeatureExtractor "
            "statistics. Mount a StableDiffusion checkpoint (CompVis .ckpt "
            "or a converted .msgpack from tools/convert_weights sd_vae) and "
            "set neural_renderer.foundation_checkpoint, or 'random-init', "
            "for the real ODISE feature path (models/sd_vae.py).",
            UserWarning, stacklevel=2)
        return StubFeatureExtractor(device=device)
    return StubFeatureExtractor(device=device)
