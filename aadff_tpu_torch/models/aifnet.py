"""AiFDepthNet and its loss (the port of `aadff_tpu/models/aifnet.py:21-193,
210-268`): an I3D-style 3D-CNN U-Net over focal stacks with softmax attention
over the stack for depth and all-in-focus regression.

Inside it is NCDHW with D = the stack.  At its boundary it keeps the JAX
package's layout: the stack comes in as [B, S, H, W, C] and the outputs
`pred_depth` [B, 1, H, W] and `pred_AiF_img` [B, 3, H, W] go out as NCHW.
The trunk is cuDNN's: the JAX package has no Pallas kernel in it.

`dtype=torch.bfloat16` is the JAX model's `dtype=jnp.bfloat16`
(`aifnet.py:98-107`): the stack is cast to bf16 and every convolution and
transposed convolution computes in bf16 with its f32 parameters cast at use;
BatchNorm takes its statistics in f32 and returns bf16; the trunk's output
is cast to f32 before the attention head, which, like the loss, stays f32
and weights the f32 stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, conv

_UP_K, _UP_S, _UP_P = (3, 4, 4), (1, 2, 2), (1, 1, 1)


class Conv3dBN(nn.Module):
    """conv3d + BN + ReLU (`aifnet.py:21-39`)."""

    def __init__(self, cin: int, cout: int, k=(1, 1, 1), s=(1, 1, 1),
                 p=(0, 0, 0), dtype=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, s, p)
        self.bn = BatchNorm(cout)
        self.dtype = dtype

    def forward(self, x):
        return F.relu(self.bn(conv(self.conv, x, self.dtype)))


class Trans3dBN(nn.Module):
    """transposed conv3d + BN + ReLU + Conv3dBN (`aifnet.py:42-61`)."""

    def __init__(self, cin: int, features: tuple[int, int], dtype=None):
        super().__init__()
        self.tconv = nn.ConvTranspose3d(cin, features[0], _UP_K, _UP_S, _UP_P)
        self.bn = BatchNorm(features[0])
        self.conv = Conv3dBN(features[0], features[1], (3, 3, 3), (1, 1, 1),
                             (1, 1, 1), dtype)
        self.dtype = dtype

    def forward(self, x):
        return self.conv(F.relu(self.bn(conv(self.tconv, x, self.dtype))))


class Mixed(nn.Module):
    """Inception block (`aifnet.py:64-83`); out_ch as in the JAX package."""

    def __init__(self, cin: int, out_ch: tuple[int, ...], dtype=None):
        super().__init__()
        oc = out_ch
        self.b0 = Conv3dBN(cin, oc[0], dtype=dtype)
        self.b1a = Conv3dBN(cin, oc[1], dtype=dtype)
        self.b1b = Conv3dBN(oc[1], oc[2], (3, 3, 3), p=(1, 1, 1), dtype=dtype)
        self.b2a = Conv3dBN(cin, oc[3], dtype=dtype)
        self.b2b = Conv3dBN(oc[3], oc[4], (3, 3, 3), p=(1, 1, 1), dtype=dtype)
        self.b3 = Conv3dBN(cin, oc[5], dtype=dtype)
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        pooled = F.max_pool3d(x, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3(pooled)], dim=1)


class AiFDepthNet(nn.Module):
    """`aifnet.py:86-193` with stage2='attention', one output class and
    unnormalised attention (the main path's configuration)."""

    def __init__(self, n_channels: int = 3, dtype=None):
        super().__init__()
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None or torch.bfloat16, got "
                             f"{dtype}")
        dt = self.dtype = dtype
        self.conv1a = Conv3dBN(n_channels, 64, (7, 7, 7), (1, 2, 2), (3, 3, 3),
                               dt)
        self.conv2b = Conv3dBN(64, 64, dtype=dt)
        self.conv2c = Conv3dBN(64, 192, (3, 3, 3), p=(1, 1, 1), dtype=dt)
        self.mixed_3b = Mixed(192, (64, 96, 128, 16, 32, 32), dt)
        self.mixed_3c = Mixed(256, (128, 128, 192, 32, 96, 64), dt)
        self.mixed_4b = Mixed(480, (192, 96, 208, 16, 48, 64), dt)
        self.mixed_4c = Mixed(512, (160, 112, 224, 24, 64, 64), dt)
        self.mixed_4d = Mixed(512, (128, 128, 256, 24, 64, 64), dt)
        self.mixed_4e = Mixed(512, (112, 144, 288, 32, 64, 64), dt)
        self.mixed_4f = Mixed(528, (256, 160, 320, 32, 128, 128), dt)
        self.mixed_5b = Mixed(832, (256, 160, 320, 32, 128, 128), dt)
        self.mixed_5c = Mixed(832, (384, 192, 384, 48, 128, 128), dt)
        self.up_5c = Trans3dBN(1024, (64, 64), dt)
        self.up_4f = Conv3dBN(832, 64, dtype=dt)
        self.up_5c4f = Trans3dBN(128, (64, 64), dt)
        self.up_3c = Conv3dBN(480, 64, dtype=dt)
        self.up_5c4f3c = Trans3dBN(128, (32, 32), dt)
        self.up_2c = Conv3dBN(192, 32, dtype=dt)
        self.up_5c4f3c2c = Trans3dBN(64, (32, 16), dt)
        self.up_1a = Conv3dBN(64, 16, dtype=dt)
        self.up_final = nn.ConvTranspose3d(32, 32, _UP_K, _UP_S, _UP_P)
        self.out = nn.Conv3d(32, 1, (3, 3, 3), (1, 1, 1), (1, 1, 1))

    def forward(self, stack: torch.Tensor, focus_position: torch.Tensor):
        """stack [B, S, H, W, C]; focus_position [B, S] ->
        {'pred_depth': [B, 1, H, W], 'pred_AiF_img': [B, 3, H, W]}."""
        B, S, H, W, C = stack.shape
        x = stack.permute(0, 4, 1, 2, 3)  # [B, C, S, H, W]
        conv1a = self.conv1a(x if self.dtype is None else x.to(self.dtype))
        h = F.max_pool3d(conv1a, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        conv2c = self.conv2c(self.conv2b(h))
        h = F.max_pool3d(conv2c, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        mix3c = self.mixed_3c(self.mixed_3b(h))
        h = F.max_pool3d(mix3c, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        mix4f = self.mixed_4f(self.mixed_4e(self.mixed_4d(
            self.mixed_4c(self.mixed_4b(h)))))
        h = F.max_pool3d(mix4f, (1, 2, 2), (1, 2, 2), (0, 0, 0))
        mix5c = self.mixed_5c(self.mixed_5b(h))

        up = self.up_5c(mix5c)
        up = self.up_5c4f(torch.cat([up, self.up_4f(mix4f)], dim=1))
        up = self.up_5c4f3c(torch.cat([up, self.up_3c(mix3c)], dim=1))
        up = self.up_5c4f3c2c(torch.cat([up, self.up_2c(conv2c)], dim=1))
        up = conv(self.up_final, torch.cat([up, self.up_1a(conv1a)], dim=1),
                  self.dtype)
        # transposed convs can overshoot by stride-1: crop to the input size;
        # the attention head runs in f32
        out = conv(self.out, up, self.dtype)[:, 0, :, :H, :W].float()

        att = torch.softmax(out, dim=1)  # over the stack
        depth = (att * focus_position.reshape(B, S, 1, 1)).sum(1, keepdim=True)
        aif = (att[:, None] * x[:, :3]).sum(2)
        return {"pred_depth": depth, "pred_AiF_img": aif}


def _image_grads(x):
    return x[..., 1:, :] - x[..., :-1, :], x[..., 1:] - x[..., :-1]


def _robust_l1(x):
    return (x ** 2 + 0.001 ** 2) ** 0.5


def _smoothness(gt_aif, d_out):
    edge_constant = 150.0
    img_gx, img_gy = _image_grads(gt_aif)
    wx = torch.exp(-((edge_constant * img_gx) ** 2).mean(1, keepdim=True))
    wy = torch.exp(-((edge_constant * img_gy) ** 2).mean(1, keepdim=True))
    d_gx, d_gy = _image_grads(d_out)
    return ((wx * _robust_l1(d_gx)).mean()
            + (wy * _robust_l1(d_gy)).mean()) / 2.0


def compute_loss(outputs: dict, input_dict: dict, task: str,
                 disp_w: float = 1.0, aif_w: float = 0.0,
                 smooth_w: float = 0.0) -> dict:
    """Losses of tasks D_FS, A_FS and DA_FS (`aifnet.py:227-268`): masked L1
    depth (mask = gt > 0), AiF L1 and edge-aware smoothness."""
    losses = {}
    d_out = outputs["pred_depth"]
    aif = outputs["pred_AiF_img"]

    def masked_mean(err, mask):
        return (err * mask).sum() / (mask.sum() + 1e-12)

    if task in ("D_FS", "DA_FS"):
        gt_d = input_dict["depth"]
        mask = (gt_d > 0).to(d_out.dtype)
        losses["depth"] = masked_mean((d_out - gt_d).abs(), mask)
        losses["disp_MSE"] = masked_mean((d_out - gt_d) ** 2, mask).detach()
    if task in ("A_FS", "DA_FS"):
        gt_aif = input_dict["AiF_img"]
        losses["AiF"] = (aif - gt_aif).abs().mean()
        losses["smooth"] = _smoothness(gt_aif, d_out)

    if task == "D_FS":
        losses["total"] = disp_w * losses["depth"]
    elif task == "A_FS":
        losses["total"] = aif_w * losses["AiF"] + smooth_w * losses["smooth"]
    elif task == "DA_FS":
        losses["total"] = (aif_w * losses["AiF"] + disp_w * losses["depth"]
                           + smooth_w * losses["smooth"])
    else:
        raise NotImplementedError(task)
    return losses
