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

from ...parallel import mesh
from ..layers import resize_bilinear, resize_trilinear
from .feat import FeatExactor
from .submodule import DecoderBlock, DisparityRegression

# The decoders of each level (`dffnet.py:23-41`), finest first:
# (name, input channels, channels, up, pool).  A decoder's first block sees
# the coarser decoder's upsampled features (channels // 2) beside the
# feature volume of its scale (vol1..vol4: 16, 32, 64, 128 channels).
DECODERS = {
    1: (("decoder3", 16, 16, False, False),),
    2: (("decoder3", 32, 32, False, False), ("decoder4", 32, 32, True, False)),
    3: (("decoder3", 32, 32, False, False), ("decoder4", 64, 32, True, False),
        ("decoder5", 64, 64, True, True)),
    4: (("decoder3", 32, 32, False, False), ("decoder4", 64, 32, True, False),
        ("decoder5", 128, 64, True, True), ("decoder6", 128, 128, True, True)),
}


class DFVNet(nn.Module):
    """`dffnet.py:DFVNet` at levels 1 to 4 (use_diff 0: Ours-FV, 1:
    Ours-DFV; `clean` is unused, as there).  Level L decodes the L finest
    feature volumes, coarsest first; levels 3 and 4 pool in their coarse
    decoders (DecoderBlock(pool=True)).

    Train mode returns (stacked, stds): the depth and std [B, 1, H, W] of
    each level, finest first.  Eval mode returns (pred [B, 1, H, W],
    std [B, H, W], prob [B, S, H, W])."""

    def __init__(self, clean: bool = False, level: int = 2,
                 use_diff: int = 1):
        super().__init__()
        if level not in DECODERS:
            raise ValueError(f"level must be 1 to 4, got {level}")
        if use_diff not in (0, 1):
            raise ValueError(f"use_diff must be 0 or 1, got {use_diff}")
        self.level = level
        self.use_diff = use_diff
        self.feature_extraction = FeatExactor()
        for name, cin, channels, up, pool in DECODERS[level]:
            setattr(self, name, DecoderBlock(cin, 2, channels, up=up, pool=pool))
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

        vol4, vol3, vol2, vol1 = (to_vol(f) for f in feats)
        # decoders 6, 5, 4 (those of the level), coarsest first, each on its
        # scale's volume beside the upsampled features of the one before
        costs, feat = {}, None
        for n, vol in ((6, vol4), (5, vol3), (4, vol2))[4 - self.level:]:
            x = vol if feat is None else torch.cat([feat, vol], 1)
            feat, costs[n] = getattr(self, f"decoder{n}")(x)
        _, cost3 = self.decoder3(vol1 if feat is None
                                 else torch.cat([feat, vol1], 1))

        cost3 = resize_bilinear(cost3, (H, W))
        prob3 = torch.softmax(cost3, dim=1)
        pred3, std3 = self.disp_reg(prob3, focal_dist, uncertainty=True)
        if not self.training:
            return pred3, std3[:, 0], prob3
        stacked, stds = [pred3], [std3]
        for n in sorted(costs):
            if n == 4:
                cost = resize_bilinear(costs[n], (H, W))
            else:  # `dffnet.py:106-119`: trilinear over (S, H, W)
                cost = resize_trilinear(costs[n][:, None], (S, H, W))[:, 0]
            pred, std = self.disp_reg(torch.softmax(cost, dim=1), focal_dist,
                                      uncertainty=True)
            stacked.append(pred)
            stds.append(std)
        return stacked, stds


def dfv_loss(stacked, stds, gt_depth, mask,
             level_weights=(1.0, 0.8, 0.6, 0.4)):
    """Multi-scale masked L1 (`dffnet.py:122-132`): the sum over levels of
    weight * mean |pred - gt| over the mask.  Under data parallelism each
    mean is that of the global batch: every level's sum and the mask's
    count are summed over the ranks in one all-reduce first
    (`parallel.mesh.global_sums`)."""
    m = mask.to(stacked[0].dtype)
    *nums, count = mesh.global_sums(
        *(((pred - gt_depth).abs() * m).sum() for pred in stacked), m.sum())
    total = 0.0
    for w, num in zip(level_weights, nums):
        total = total + w * num / (count + 1e-12)
    return total
