"""ResNet-18 + pyramid pooling + FPN feature extractor of DFVNet (the port of
`aadff_tpu/models/dfv/feat.py`), channels first: [N, 3, H, W] -> the four
projections at 1/32, 1/16, 1/8 and 1/4 of the input."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, resize_bilinear


class BasicBlock(nn.Module):
    """ResNet basic block (`feat.py:BasicBlock`)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, features, 1, stride, 0, bias=False),
                BatchNorm(features))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConvBNLeakyRelu(nn.Module):
    """conv2d + BN + LeakyReLU(0.1) (`feat.py:ConvBNLeakyRelu`)."""

    def __init__(self, cin: int, features: int, k_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, k_size, stride, padding,
                              bias=bias)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class PyramidPoolingSum(nn.Module):
    """Sum-mode pyramid pooling over 4 scales (`feat.py:PyramidPoolingSum`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.paths = nn.ModuleList(
            ConvBNLeakyRelu(channels, channels, 1, 1, 0) for _ in range(4))

    def forward(self, x):
        H, W = x.shape[-2:]
        pp_sum = x
        sizes = np.linspace(1, min(H, W) // 2, 4, dtype=int)[::-1]
        for path, pool_size in zip(self.paths, sizes):
            ksz = (int(H / pool_size), int(W / pool_size))
            out = path(F.avg_pool2d(x, ksz, ksz))
            pp_sum = pp_sum + 0.25 * resize_bilinear(out, (H, W))
        return F.relu(pp_sum / 2.0)


def _layer(cin: int, features: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(cin, features, stride),
                         BasicBlock(features, features, 1))


class FeatExactor(nn.Module):
    """`feat.py:FeatExactor`: [N, 3, H, W] -> (proj6 [N, 128, H/32, W/32],
    proj5 [N, 64, H/16, W/16], proj4 [N, 32, H/8, W/8],
    proj3 [N, 16, H/4, W/4])."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)
        self.pyramid_pooling = PyramidPoolingSum(512)
        self.upconv6 = ConvBNLeakyRelu(512, 256)
        self.iconv5 = ConvBNLeakyRelu(512, 256)
        self.upconv5 = ConvBNLeakyRelu(256, 128)
        self.iconv4 = ConvBNLeakyRelu(256, 128)
        self.upconv4 = ConvBNLeakyRelu(128, 64)
        self.iconv3 = ConvBNLeakyRelu(128, 64)
        self.proj6 = ConvBNLeakyRelu(512, 128, 1, 1, 0)
        self.proj5 = ConvBNLeakyRelu(256, 64, 1, 1, 0)
        self.proj4 = ConvBNLeakyRelu(128, 32, 1, 1, 0)
        self.proj3 = ConvBNLeakyRelu(64, 16, 1, 1, 0)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        pool1 = F.max_pool2d(h, 3, 2, 1)
        conv3 = self.layer1(pool1)    # 1/4
        conv4 = self.layer2(conv3)    # 1/8
        conv5 = self.layer3(conv4)    # 1/16
        conv6 = self.pyramid_pooling(self.layer4(conv5))  # 1/32

        def up2(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        conv5 = self.iconv5(torch.cat([conv5, self.upconv6(up2(conv6))], 1))
        conv4 = self.iconv4(torch.cat([conv4, self.upconv5(up2(conv5))], 1))
        conv3 = self.iconv3(torch.cat([conv3, self.upconv4(up2(conv4))], 1))
        return (self.proj6(conv6), self.proj5(conv5), self.proj4(conv4),
                self.proj3(conv3))
