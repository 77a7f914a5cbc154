"""Image quality metrics (MSE / PSNR / SSIM) on the device, in PyTorch.

Counterpart of `tpu_diffusion/eval/metrics.py`. SSIM follows
skimage.metrics.structural_similarity's defaults (uniform 7x7 window, valid
padding, K1=0.01, K2=0.03, unbiased covariances). Layout NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE over [B, H, W, C]."""
    return torch.mean((a - b) ** 2, dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR; default range 2.0 for [-1, 1] images."""
    return 10.0 * torch.log10(data_range ** 2
                              / torch.clamp(mse(a, b), min=1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over size x size windows, valid padding, per channel (a grouped
    conv). x: [B, C, H, W]."""
    c = x.shape[1]
    kernel = torch.full((c, 1, size, size), 1.0 / (size * size),
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, kernel, groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0,
         win_size: int = 7, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Per-sample mean SSIM over [B, H, W, C] (channels averaged)."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    var_a = cov_norm * (_uniform_filter(a * a, win_size) - mu_a ** 2)
    var_b = cov_norm * (_uniform_filter(b * b, win_size) - mu_b ** 2)
    cov = cov_norm * (_uniform_filter(a * b, win_size) - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def eval_statistics(pred: torch.Tensor, truth: torch.Tensor,
                    data_range: float = 2.0) -> Dict[str, torch.Tensor]:
    """mean/median/std of MSE, PSNR, SSIM over the batch, as
    `jnp.mean`/`jnp.median`/`jnp.std` give them: the median of an even count
    is the mean of the two middle values (`torch.median` would return the
    lower one) and the std is the population std (correction 0)."""
    out = {}
    for name, vals in [("mse", mse(pred, truth)),
                       ("psnr", psnr(pred, truth, data_range)),
                       ("ssim", ssim(pred, truth, data_range))]:
        vals = vals.float()
        out[f"{name}_mean"] = torch.mean(vals)
        out[f"{name}_median"] = torch.quantile(vals, 0.5)
        out[f"{name}_std"] = torch.std(vals, correction=0)
    return out
