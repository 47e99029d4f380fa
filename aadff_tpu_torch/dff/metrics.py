"""Depth and all-in-focus image metrics (the port of
`aadff_tpu/dff/metrics.py`).

Depth metrics (:19-108) run on tensors and return 0-d tensors; masked
variants take a boolean mask of valid pixels, unmasked variants skip
infinite terms as the reference does.  Bumpiness and the image-quality
metrics (:111-212) run on the host in float64 numpy with scipy's filters,
as the JAX package computes them: PSNR and SSIM (skimage's defaults, a
uniform 7x7 window, K1 = 0.01, K2 = 0.03) on images quantised to uint8,
which is what the reference calls (reference dff/metrics.py:134-158).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import convolve, uniform_filter


def mask_abs_rel(est_depth, gt_depth, mask):
    return ((gt_depth[mask] - est_depth[mask]).abs() / gt_depth[mask]).mean()


def mask_sq_rel(est_depth, gt_depth, mask):
    return ((gt_depth[mask] - est_depth[mask]) ** 2 / gt_depth[mask]).mean()


def mask_mse(est_depth, gt_depth, mask):
    return ((gt_depth[mask] - est_depth[mask]) ** 2).mean()


def mask_mae(est_depth, gt_depth, mask):
    return (gt_depth[mask] - est_depth[mask]).abs().mean()


def mask_rmse(est_depth, gt_depth, mask):
    return ((est_depth[mask] - gt_depth[mask]) ** 2).mean().sqrt()


def mask_rmse_log(est_depth, gt_depth, mask):
    return ((gt_depth[mask].log() - est_depth[mask].log()) ** 2).mean().sqrt()


def mask_accuracy_k(est_depth, gt_depth, k, mask):
    a = est_depth[mask] / gt_depth[mask]
    b = gt_depth[mask] / est_depth[mask]
    return (torch.maximum(a, b) < 1.25 ** k).sum() / mask.sum()


def mask_mse_w_conf(est_depth, gt_depth, conf, mask):
    c = conf[mask]
    return (c * (gt_depth[mask] - est_depth[mask]) ** 2).sum() / c.sum()


def mask_mae_w_conf(est_depth, gt_depth, conf, mask):
    c = conf[mask]
    return (c * (gt_depth[mask] - est_depth[mask]).abs()).sum() / c.sum()


def _finite_mean(out):
    total = (~torch.isinf(out)).sum()
    return torch.where(torch.isinf(out), 0, out).sum() / total


def abs_rel(est_depth, gt_depth):
    return _finite_mean((gt_depth - est_depth).abs() / gt_depth)


def sq_rel(est_depth, gt_depth):
    return _finite_mean((gt_depth - est_depth) ** 2 / gt_depth)


def mae(est_depth, gt_depth):
    return (gt_depth - est_depth).abs().mean()


def mse(est_depth, gt_depth):
    return ((gt_depth - est_depth) ** 2).mean()


def rmse(est_depth, gt_depth):
    return mse(est_depth, gt_depth).sqrt()


def rmse_log(est_depth, gt_depth):
    gt, est = gt_depth.log(), est_depth.log()
    total = (~torch.isinf(est) & ~torch.isinf(gt)).sum()
    out = (gt - est) ** 2
    return (torch.where(torch.isinf(out), 0, out).sum() / total).sqrt()


def accuracy_k(est_depth, gt_depth, k):
    thresh = torch.maximum(est_depth / gt_depth, gt_depth / est_depth)
    total = (~torch.isinf(thresh)).sum()
    return (thresh < 1.25 ** k).sum() / total


# ================================
# Bumpiness (reference dff/metrics.py:45-81), host numpy
# ================================
_SCHARR_V = np.array([[3, 0, -3], [10, 0, -10], [3, 0, -3]], np.float64) / 32
_SCHARR_H = _SCHARR_V.T.copy()


def _scharr_v(img):
    return convolve(img, _SCHARR_V, mode="reflect")


def _scharr_h(img):
    return convolve(img, _SCHARR_H, mode="reflect")


def get_bumpiness(gt, algo_result, mask, clip=0.05, factor=100):
    gt = np.asarray(gt, np.float64)
    algo_result = np.asarray(algo_result, np.float64)
    if gt.ndim == 4:
        gt = gt[0, 0]
    if algo_result.ndim == 4:
        algo_result = algo_result[0, 0]
    if np.asarray(mask).ndim == 4:
        mask = np.asarray(mask)[0, 0]
    diff = algo_result - gt
    dx, dy = _scharr_v(diff), _scharr_h(diff)
    bump = np.sqrt(
        np.square(_scharr_v(dx)) + np.square(_scharr_h(dx))
        + np.square(_scharr_h(dy)) + np.square(_scharr_v(dy))
    )
    bump = np.clip(bump, 0, clip)
    return np.mean(bump[mask]) * factor


def get_bumpiness_non_mask(gt, algo_result, clip=0.05, factor=100):
    ones = np.ones(np.asarray(gt).shape[-2:], bool)
    return get_bumpiness(gt, algo_result, ones, clip, factor)


# ================================
# Image quality (reference dff/metrics.py:134-158), host numpy
# ================================
def _to_uint8(img):
    img = np.asarray(img, np.float64)
    return np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)


def psnr(img_clean, img, data_range=255):
    img_clean = np.asarray(img_clean, np.float64)
    img = np.asarray(img, np.float64)
    err = np.mean((img_clean - img) ** 2)
    return 10 * np.log10(data_range**2 / err)


def ssim(img_clean, img, data_range=255, win_size=7, channel_axis=None,
         K1=0.01, K2=0.03):
    """Structural similarity, skimage-compatible defaults (uniform window;
    scipy's `reflect` border, which repeats the edge sample)."""
    x = np.asarray(img_clean, np.float64)
    y = np.asarray(img, np.float64)
    if channel_axis is not None:
        x = np.moveaxis(x, channel_axis, 0)
        y = np.moveaxis(y, channel_axis, 0)
        return np.mean(
            [ssim(xc, yc, data_range, win_size) for xc, yc in zip(x, y)]
        )
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    NP = win_size**2
    cov_norm = NP / (NP - 1)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux**2 + uy**2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def batch_PSNR(img, img_clean):
    """uint8-quantised batch PSNR (reference dff/metrics.py:137-145)."""
    a = _to_uint8(img)
    b = _to_uint8(img_clean)
    vals = [psnr(b[i], a[i]) for i in range(a.shape[0])]
    return round(float(np.mean(vals)), 4)


def batch_SSIM(img, img_clean):
    """uint8-quantised batch SSIM over channels (reference dff/metrics.py:147-155)."""
    a = _to_uint8(img)
    b = _to_uint8(img_clean)
    vals = [ssim(b[i], a[i], channel_axis=0) for i in range(a.shape[0])]
    return round(float(np.mean(vals)), 4)


def mask_psnr(est_aif, gt_aif):
    return batch_PSNR(np.asarray(est_aif), np.asarray(gt_aif))


def mask_ssim(est_aif, gt_aif):
    return batch_SSIM(np.asarray(est_aif), np.asarray(gt_aif))
