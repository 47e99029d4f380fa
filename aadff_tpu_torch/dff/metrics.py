"""Depth metrics (the port of `aadff_tpu/dff/metrics.py:19-108`), on tensors.

Masked variants take a boolean mask of valid pixels; unmasked variants skip
infinite terms as the reference does.  Each returns a 0-d tensor.
"""
from __future__ import annotations

import torch


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
