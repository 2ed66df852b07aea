"""Image quality metrics: PSNR and SSIM (a copy of
tensorf_tpu/eval/metrics.py, numpy and scipy only).

SSIM follows the mipnerf-style separable-Gaussian formulation the reference
uses (loss.py:62-117): filter_size 11, sigma 1.5, k1 0.01, k2 0.03, valid
padding, covariance clipping.  LPIPS (eval/lpips.py) needs its nets'
weights, which are not in the repo: without them ``rgb_lpips`` returns
None, and evaluation then writes NaN into mean.txt's LPIPS lines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.signal


def psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    mse = float(np.mean((img0 - img1) ** 2))
    return float(-10.0 * np.log(mse) / np.log(10.0))


def rgb_ssim(
    img0,
    img1,
    max_val,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    assert img0.ndim == 3 and img0.shape[-1] == 3
    assert img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [
                convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
                for i in range(z.shape[-1])
            ],
            -1,
        )

    mu0, mu1 = filt_fn(img0), filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = filt_fn(img0**2) - mu00
    sigma11 = filt_fn(img1**2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


def rgb_lpips(np_gt, np_im, net_name: str = "alex", device=None) -> Optional[float]:
    """LPIPS distance on ``device`` (cuda unless asked), or None when the
    net's weights are not found (eval/lpips.py: ``TENSORF_LPIPS_DIR``)."""
    from .lpips import lpips

    return lpips(np_gt, np_im, net=net_name, device=device)
