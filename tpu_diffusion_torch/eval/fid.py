"""Frechet distance evaluation pipeline, in PyTorch.

Counterpart of `tpu_diffusion/eval/fid.py`:

  features -> running (mu, sigma) statistics -> Frechet distance,

with a pluggable feature extractor (`make_feature_fn`):

  * "inception": InceptionV3 pool3 features (`eval/inception.py`) from a
    local .npz of the JAX package's variable tree (`INCEPTION_WEIGHTS_NPZ`);
    the repository holds no weights and nothing is downloaded;
  * "inception_random": the same graph at its random initialisation
    (architecture and latency only, not a valid FID);
  * "random_conv": a fixed-seed random conv net, always available.

The random weights are drawn from a fixed torch seed on a CPU generator, so
every device gets the same ones. They are not the JAX package's, which come
from flax keys the port cannot replay: "random_conv" numbers are
self-consistent across runs of the port and comparable neither to the JAX
package's nor to published Inception-FID values (`fid_caveat` says so).

On the card the feature networks run in full fp32 (`full_fp32`): TF32 is
off for their convs and products whatever the process has set, because FID
moves with the features' precision.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.models.unet import SameConv2d, resolve_device

FeatureFn = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Frechet distance (numpy and scipy, as in the JAX package)
# ---------------------------------------------------------------------------


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}).

    Matrix sqrt via scipy when available, else the eigenvalues of S1 S2.
    `sqrtm` is called without `disp` (deprecated in SciPy 1.16, gone in
    1.18): the root is the same, only the error estimate is not returned.
    """
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2
    try:
        from scipy import linalg
        covmean = linalg.sqrtm(sigma1 @ sigma2)
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    except ImportError:
        # Tr((S1 S2)^{1/2}) = sum of sqrt of the eigenvalues of S1 @ S2
        # (similar to the SPD matrix S2^{1/2} S1 S2^{1/2}, so the spectrum
        # is real non-negative up to roundoff). Symmetrizing the product
        # first is NOT equivalent for non-commuting S1, S2 and biases FID.
        s = np.linalg.eigvals(sigma1 @ sigma2).real
        tr_covmean = np.sum(np.sqrt(np.clip(s, 0, None)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_fp32():
    """fp32 convs and products without TF32 inside the block (PyTorch lets
    cuDNN take TF32 for fp32 convs by default); the flags are restored on
    exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator
                       ) -> nn.Module:
    """flax's default initialisation, drawn on the CPU from `generator`:
    conv and dense kernels lecun_normal (a normal truncated at two standard
    deviations, variance 1 / fan_in), biases 0. BatchNorm statistics keep
    their mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # the std of a unit normal truncated to [-2, 2] is 0.8796...
            std = fan_in ** -0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


def feature_fn(net: nn.Module) -> FeatureFn:
    """images -> net(images) without gradients, in full fp32, with the
    images (numpy or a tensor, NHWC in [-1, 1]) moved to the net's device."""
    device = next(net.parameters()).device

    @torch.no_grad()
    def fn(images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=device)
        with full_fp32():
            return net(x)

    return fn


class RandomConvFeatures(nn.Module):
    """Fixed random conv net: [B, H, W, channels] -> [B, features], fp32.

    `depth` strided 3x3 convs with flax "SAME" padding (the odd row and
    column at the end) and leaky-ReLU 0.2, widths `width` doubling per
    layer, a global mean, a dense layer. Submodules carry the flax names
    (`Conv_0`.., `Dense_0`)."""

    def __init__(self, channels: int = 3, width: int = 128, depth: int = 4,
                 features: int = 2048, device=None):
        super().__init__()
        self.depth = depth
        cin, w = channels, width
        for i in range(depth):
            self.add_module(f"Conv_{i}", SameConv2d(
                cin, w, 3, stride=2, dtype=torch.float32, device=device))
            cin, w = w, 2 * w
        self.Dense_0 = nn.Linear(cin, features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            h = F.leaky_relu(getattr(self, f"Conv_{i}")(h), 0.2)
        return self.Dense_0(h.mean(dim=(2, 3)))


def fid_caveat(features: str, synthetic_data: bool = False) -> dict:
    """Machine-readable caveat fields for any results payload carrying a
    FID, keyed as the JAX package's: numbers from non-Inception features
    and/or synthetic-fallback data are self-consistent across runs of the
    port but NOT comparable to published Inception-FID values."""
    notes = []
    if features != "inception":
        notes.append(f"{features} features (no pretrained Inception "
                     "weights in this environment; random weights from a "
                     "fixed torch seed, which are not the JAX package's)")
    if synthetic_data:
        notes.append("synthetic-fallback dataset (no real data in this "
                     "environment)")
    if not notes:
        return {"fid_comparable_to_published": True}
    return {
        "fid_comparable_to_published": False,
        "fid_note": (", ".join(notes) + ": self-consistent across runs "
                     "of the PyTorch port, NOT comparable to published "
                     "Inception-FID values nor to the JAX package's "
                     "random-feature FID (see tpu_diffusion_torch/eval/"
                     "fid.py; real weights: an .npz from "
                     "scripts/import_inception_weights.py)"),
    }


def make_feature_fn(kind: str = "random_conv", channels: int = 3,
                    weights_path: Optional[str] = None,
                    device="cuda") -> FeatureFn:
    """images ([-1, 1] NHWC, numpy or tensor) -> [N, D] features on
    `device`."""
    device = resolve_device(device)
    if kind == "random_conv":
        net = RandomConvFeatures(channels)
        flax_default_init_(net, torch.Generator().manual_seed(42))
        return feature_fn(net.to(device).eval())
    if kind == "inception":
        path = weights_path or os.environ.get("INCEPTION_WEIGHTS_NPZ", "")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "InceptionV3 weights .npz not found; set "
                "INCEPTION_WEIGHTS_NPZ or use feature kind 'random_conv' "
                "(no network egress in this environment). The full "
                "architecture lives in tpu_diffusion_torch/eval/inception.py "
                "(use kind='inception_random' for a random-init graph)")
        from tpu_diffusion_torch.eval.inception import load_inception_fn
        return load_inception_fn(path, device)
    if kind == "inception_random":
        from tpu_diffusion_torch.eval.inception import load_inception_fn
        return load_inception_fn(None, device)
    raise NotImplementedError(f"Unknown feature extractor {kind!r}")


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class FID:
    """Running-statistics FID accumulator: update(imgs, real=...) /
    compute()."""

    def __init__(self, feature_fn: FeatureFn):
        self._fn = feature_fn
        self._real: list = []
        self._fake: list = []
        self._real_stats = None

    def update(self, images, real: bool):
        feats = self._fn(images).cpu().numpy()
        (self._real if real else self._fake).append(feats)

    def real_statistics(self):
        """(mu, sigma) of the real features seen so far — cacheable."""
        if self._real_stats is None:
            self._real_stats = compute_statistics(
                np.concatenate(self._real))
        return self._real_stats

    def set_real_statistics(self, mu, sigma):
        """Install precomputed real-split statistics (skips the real
        pass — they are a pure function of dataset/features/shape)."""
        self._real_stats = (np.asarray(mu), np.asarray(sigma))

    def compute(self) -> float:
        mu_r, s_r = self.real_statistics()
        mu_f, s_f = compute_statistics(np.concatenate(self._fake))
        return frechet_distance(mu_r, s_r, mu_f, s_f)


def compute_fid(gen_batches: Iterator, real_batches: Iterator,
                feature_fn: FeatureFn) -> float:
    """Stream real and generated batches through the feature net and return
    the Frechet distance of their statistics."""
    fid = FID(feature_fn)
    for b in real_batches:
        fid.update(b, real=True)
    for b in gen_batches:
        fid.update(b, real=False)
    return fid.compute()
