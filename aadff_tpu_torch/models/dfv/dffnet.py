"""DFVNet, the focus-volume depth-from-focus network, and its loss (the port
of `aadff_tpu/models/dfv/dffnet.py`).

Inside it is channels first: 2D features [B*S, C, h, w], cost volumes
[B, C, S, h, w].  At its boundary it keeps the JAX package's layout: the
stack comes in as [B, S, H, W, C]; depths go out as [B, 1, H, W].  The trunk
is cuDNN's: the JAX package has no Pallas kernel in it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import resize_bilinear
from .feat import FeatExactor
from .submodule import DecoderBlock, DisparityRegression


class DFVNet(nn.Module):
    """`dffnet.py:DFVNet` (use_diff 0: Ours-FV, 1: Ours-DFV; `clean` is
    unused, as there) at level 2, the level of the paper's configuration;
    levels 1, 3 and 4 are not ported yet (3 and 4 need
    DecoderBlock(pool=True)).

    Train mode returns (stacked, stds): the depth and std [B, 1, H, W] of
    each level, finest first.  Eval mode returns (pred [B, 1, H, W],
    std [B, H, W], prob [B, S, H, W])."""

    def __init__(self, clean: bool = False, level: int = 2,
                 use_diff: int = 1):
        super().__init__()
        if level != 2:
            raise NotImplementedError(f"DFVNet level {level} is not ported yet")
        if use_diff not in (0, 1):
            raise ValueError(f"use_diff must be 0 or 1, got {use_diff}")
        self.use_diff = use_diff
        self.feature_extraction = FeatExactor()
        self.decoder3 = DecoderBlock(32, 2, 32)
        self.decoder4 = DecoderBlock(32, 2, 32, up=True)
        self.disp_reg = DisparityRegression(1)

    @staticmethod
    def _diff_volume(vol):
        """Adjacent-frame differencing over the stack dim (`dffnet.py:43-48`);
        vol [B, C, S, h, w]."""
        return torch.cat([vol[:, :, :-1] - vol[:, :, 1:], vol[:, :, -1:]], 2)

    def forward(self, stack: torch.Tensor, focal_dist: torch.Tensor):
        """stack [B, S, H, W, 3]; focal_dist [B, S]."""
        B, S, H, W, C = stack.shape
        flat = stack.reshape(B * S, H, W, C).permute(0, 3, 1, 2)
        feats = self.feature_extraction(flat)

        def to_vol(f):
            _, c, h, w = f.shape
            vol = f.reshape(B, S, c, h, w).transpose(1, 2)
            return self._diff_volume(vol) if self.use_diff == 1 else vol

        _, _, vol2, vol1 = (to_vol(f) for f in feats)
        feat4_2x, cost4 = self.decoder4(vol2)
        _, cost3 = self.decoder3(torch.cat([feat4_2x, vol1], 1))

        cost3 = resize_bilinear(cost3, (H, W))
        prob3 = torch.softmax(cost3, dim=1)
        pred3, std3 = self.disp_reg(prob3, focal_dist, uncertainty=True)
        if not self.training:
            return pred3, std3[:, 0], prob3
        prob4 = torch.softmax(resize_bilinear(cost4, (H, W)), dim=1)
        pred4, std4 = self.disp_reg(prob4, focal_dist, uncertainty=True)
        return [pred3, pred4], [std3, std4]


def dfv_loss(stacked, stds, gt_depth, mask,
             level_weights=(1.0, 0.8, 0.6, 0.4)):
    """Multi-scale masked L1 (`dffnet.py:122-132`): the sum over levels of
    weight * mean |pred - gt| over the mask."""
    m = mask.to(stacked[0].dtype)
    total = 0.0
    for w, pred in zip(level_weights, stacked):
        total = total + w * ((pred - gt_depth).abs() * m).sum() / (m.sum() + 1e-12)
    return total
