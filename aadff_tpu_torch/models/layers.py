"""Layers of the DFF models that differ from PyTorch's defaults (the port of
`aadff_tpu/models/layers.py`).

The convolutions, transposed convolutions and max-pools of the JAX package
pin torch's geometry (`layers.py:23-103`), so the port uses `nn.Conv3d`,
`nn.ConvTranspose3d` and `F.max_pool3d` as they are.  What differs is
BatchNorm's running statistics: Flax keeps `momentum * old + (1 - momentum)
* batch` with momentum 0.9 and the *biased* batch variance, where
`nn.BatchNorm3d` uses momentum 0.1 on the new value and the unbiased one.

A compute dtype (`dtype=torch.bfloat16`, Flax's `dtype` on `TorchConv`,
`TorchConvTranspose` and `nn.BatchNorm`) keeps the parameters in f32 and
casts them at use: `conv` computes in the input's cast, and BatchNorm takes
its statistics in f32 and returns the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with Flax's running statistics (`nn.BatchNorm(
    momentum=0.9, epsilon=1e-5)`, `aadff_tpu/models/aifnet.py:37-38`)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # statistics and the normalisation in f32, the result in x's dtype,
        # as Flax's BatchNorm(dtype=bf16) does (`_compute_stats` promotes to
        # f32); for an f32 input both casts are no-ops
        dtype = x.dtype
        x = x.float()
        if self.training:
            with torch.no_grad():
                dims = [0, *range(2, x.dim())]
                var, mean = torch.var_mean(x, dim=dims, unbiased=False)
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var)
            # normalises with the biased batch variance, as Flax does
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, momentum=0.0, eps=self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             momentum=0.0, eps=self.eps)
        return y.to(dtype)


def conv(module: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """`module` (an nn.Conv3d or nn.ConvTranspose3d) applied to x, in
    `dtype` when it is given: input, kernel and bias are cast at use and the
    f32 parameters stay as they are."""
    if dtype is None:
        return module(x)
    w, b = module.weight.to(dtype), module.bias.to(dtype)
    if isinstance(module, nn.ConvTranspose3d):
        return F.conv_transpose3d(x.to(dtype), w, b, module.stride,
                                  module.padding, module.output_padding,
                                  module.groups, module.dilation)
    return module._conv_forward(x.to(dtype), w, b)


# `jax.image.resize` and `F.interpolate(..., align_corners=False)` agree when
# they upsample (half-pixel centres, edge samples clamped).  When it
# downsamples, JAX widens the kernel to antialias and torch does not; every
# call in the DFV models upsamples.
def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """x [N, C, H, W] -> bilinear resize of (H, W) to `size` (the port of
    `aadff_tpu/models/layers.py:resize_bilinear`, channels first)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def resize_trilinear(x: torch.Tensor, size) -> torch.Tensor:
    """x [N, C, D, H, W] -> trilinear resize of (D, H, W) to `size` (the port
    of `aadff_tpu/models/layers.py:resize_trilinear`, channels first)."""
    return F.interpolate(x, size=tuple(size), mode="trilinear",
                         align_corners=False)
