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

Under data parallelism (`parallel/mesh.py`) BatchNorm's batch statistics
are those of the global batch, as JAX's are under a sharded `jit`; and
`checkpoint` recomputes a block in the backward pass as Flax's `nn.remat`
does, without touching the statistics a second time.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel import mesh


class _Remat:
    """What BatchNorm does inside a block that `checkpoint` runs: None
    outside one; "record" in its first forward, where each BatchNorm keeps
    the ranks' statistics it gathered in `sums`; "replay" in its
    recomputation, where each takes them back in the same order, gathers
    nothing and updates no running statistic."""
    mode: str | None = None
    sums: list | None = None
    next: int = 0


@contextlib.contextmanager
def _remat(mode: str, sums: list):
    saved = _Remat.mode, _Remat.sums, _Remat.next
    _Remat.mode, _Remat.sums, _Remat.next = mode, sums, 0
    try:
        yield
    finally:
        _Remat.mode, _Remat.sums, _Remat.next = saved


def checkpoint(fn, *args):
    """fn(*args) with its activations recomputed in the backward pass
    (`torch.utils.checkpoint`, non-reentrant; Flax's `nn.remat`).  The
    recomputation leaves BatchNorm's running statistics alone and reuses
    the ranks' statistics of the first pass instead of gathering them
    again."""
    sums: list = []
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (_remat("record", sums), _remat("replay", sums)))


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
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             momentum=0.0, eps=self.eps)
        elif mesh.distributed():
            y = self._global(x)
        else:
            if _Remat.mode != "replay":
                with torch.no_grad():
                    dims = [0, *range(2, x.dim())]
                    var, mean = torch.var_mean(x, dim=dims, unbiased=False)
                    self._update(mean, var)
            if x.numel() == x.shape[1]:
                # one value per channel (a batch of 1 through DecoderBlock's
                # global pool), which F.batch_norm refuses: Flax normalises
                # it to 0, so the result is the bias
                shape = (1, -1) + (1,) * (x.dim() - 2)
                y = ((x - x) * self.weight.reshape(shape)
                     + self.bias.reshape(shape))
            else:
                # normalises with the biased batch variance, as Flax does
                y = F.batch_norm(x, None, None, self.weight, self.bias,
                                 training=True, momentum=0.0, eps=self.eps)
        return y.to(dtype)

    @torch.no_grad()
    def _update(self, mean, var):
        self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
        self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BatchNorm over the global batch.  Each rank takes the
        count, mean and sum of squared deviations of each channel over its
        rows; the ranks' triples are gathered (forward and backward, in one
        all-reduce) and combined exactly (Chan et al.'s parallel variance,
        as SyncBatchNorm combines them), so the statistics are those of one
        process holding the whole batch: the biased variance, taken in two
        passes as `F.batch_norm` takes it.  (Flax takes E[x^2] - E[x]^2,
        which loses digits where a channel's mean is far above its
        spread: ROADMAP C.)  One value per channel in the whole batch needs
        no case of its own: x - mean is then exactly 0."""
        C = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean_r = x.mean(dims)
        m2_r = (x - mean_r.reshape(shape)).square().sum(dims)
        local = torch.cat([x.new_full((1,), x.numel() // C), mean_r, m2_r])
        if _Remat.mode == "replay":
            rows = mesh.gather_rows(local, _Remat.sums[_Remat.next])
            _Remat.next += 1
        else:
            rows = mesh.gather_rows(local)
            if _Remat.mode == "record":
                _Remat.sums.append(rows.detach())
        counts, means, m2s = rows[:, :1], rows[:, 1:C + 1], rows[:, C + 1:]
        count = counts.sum()
        mean = (counts * means).sum(0) / count
        var = (m2s.sum(0) + (counts * (means - mean).square()).sum(0)) / count
        if _Remat.mode != "replay":
            self._update(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


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
