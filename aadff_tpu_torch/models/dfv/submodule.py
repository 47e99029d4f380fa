"""DFV 3D cost-volume submodules (the port of
`aadff_tpu/models/dfv/submodule.py`), channels first: a volume is
[B, C, S, h, w] with S the focal stack."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, resize_trilinear


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class SepConv3d(nn.Module):
    """conv3d, then BN unless the conv has a bias (`submodule.py:SepConv3d`)."""

    def __init__(self, cin: int, features: int, kernel_size=3,
                 stride=(1, 1, 1), pad=1, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, _triple(kernel_size),
                              _triple(stride), _triple(pad), bias=bias)
        self.bn = None if bias else BatchNorm(features)

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class ProjFeat3d(nn.Module):
    """3D -> 2D projection conv (`submodule.py:ProjFeat3d`): a 1x1 conv2d
    with strides stride[:2] over (S, h*w)."""

    def __init__(self, cin: int, features: int, stride=(1, 1, 1)):
        super().__init__()
        self.stride = _triple(stride)
        self.conv = nn.Conv2d(cin, features, 1, self.stride[:2], 0,
                              bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):
        B, C, D, H, W = x.shape
        h = self.bn(self.conv(x.reshape(B, C, D, H * W)))
        return h.reshape(B, -1, D // self.stride[0], H, W)


class SepConv3dBlock(nn.Module):
    """Residual 3D conv block (`submodule.py:SepConv3dBlock`)."""

    def __init__(self, cin: int, features: int, stride=(1, 1, 1)):
        super().__init__()
        stride = _triple(stride)
        self.conv1 = SepConv3d(cin, features, 3, stride, 1)
        self.downsample = None
        if cin != features or stride != (1, 1, 1):
            self.downsample = ProjFeat3d(cin, features, stride)
        self.conv2 = SepConv3d(features, features, 3, (1, 1, 1), 1)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + self.conv2(out))


class DisparityRegression(nn.Module):
    """Softmax-weighted focus-distance regression and its uncertainty std
    (`submodule.py:DisparityRegression`).  The std is computed around the
    detached regression and is itself detached, as `stop_gradient` does."""

    def __init__(self, divisor: float = 1.0):
        super().__init__()
        self.divisor = divisor

    def forward(self, prob, focal_dist, uncertainty: bool = False):
        """prob [B, S, H, W], softmaxed over S; focal_dist [B, S]."""
        disp = focal_dist[..., None, None]
        out = (prob * disp).sum(1, keepdim=True) * self.divisor
        if uncertainty:
            std = (prob * (out.detach() - disp) ** 2).sum(1, keepdim=True).sqrt()
            return out, std.detach()
        return out


class DecoderBlock(nn.Module):
    """3D-conv decoder cascade (`submodule.py:DecoderBlock`).  Returns
    (features, cost [B, S, h, w]).  The cost is computed before the
    upsample in train and eval mode alike, as the JAX package does
    (PARITY.md: the reference's eval path for up-blocks returns a cost that
    is never consumed)."""

    def __init__(self, cin: int, nconvs: int, channels: int,
                 stride=(1, 1, 1), up: bool = False, nstride: int = 1,
                 pool: bool = False):
        super().__init__()
        if pool:
            raise NotImplementedError(
                "DecoderBlock(pool=True), used by DFVNet levels 3 and 4, is "
                "not ported yet")
        strides = ([_triple(stride)] * nstride
                   + [(1, 1, 1)] * (nconvs - nstride))
        self.convs = nn.ModuleList(
            SepConv3dBlock(cin if i == 0 else channels, channels, strides[i])
            for i in range(nconvs))
        self.classify = nn.Sequential(
            SepConv3d(channels, channels, 3, (1, 1, 1), 1), nn.ReLU(),
            SepConv3d(channels, 1, 3, (1, 1, 1), 1, bias=True))
        self.up_conv = (SepConv3d(channels, channels // 2, 3, (1, 1, 1), 1)
                        if up else None)

    def forward(self, fvl):
        for block in self.convs:
            fvl = block(fvl)
        costl = self.classify(fvl)[:, 0]
        if self.up_conv is not None:
            D, H, W = fvl.shape[2:]
            fvl = F.relu(self.up_conv(resize_trilinear(fvl, (D, 2 * H, 2 * W))))
        return fvl, costl
